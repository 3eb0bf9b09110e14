"""Serialized per-stage device profile of the MEG3-full scan.

Runs the batched driver's stages by hand with everything synchronous
(one batch at a time, blocking after each device call) so each stage's
true device cost is visible — the production driver overlaps these,
so the sum here is an upper bound on warm wall time.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from fasim_tpu import rules
from fasim_tpu.cli import make_engine
from fasim_tpu.config import BYTE_SAT, Params, TpuConfig
from fasim_tpu.io import fasta
from fasim_tpu.scan.batched import _ScanMeta, enumerate_work
from fasim_tpu.scan import candidates as C

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    os.chdir(os.path.join(REPO, "oracle"))
    p = Params(file1path="meg3dna.fa", file2path="MEG3.fa", outpath="/tmp")
    records = fasta.read_dna(p.file1path)
    _, rna = fasta.read_rna(p.file2path)
    eng = make_engine(TpuConfig(), rna)[0]
    work, scans = enumerate_work(p, records)
    print(f"{len(work)} segments")
    eng.setup_scans(scans)
    eng.setup_windows(rna)
    meta = _ScanMeta(scans)
    q_idx = np.ascontiguousarray(rules.SSW_ENC[rna], np.int32)
    n_pad = (max(len(w.segment) for w in work) + 127) // 128 * 128
    B = 64
    m16 = (len(rna) + 15) // 16 * 16

    for rep in range(2):
        t = {"scan": 0.0, "pack_fetch": 0.0, "peaks": 0.0, "fwd": 0.0,
             "rev": 0.0}
        rows_hist = []
        t_all = time.time()
        for lo in range(0, len(work), B):
            batch = work[lo:lo + B]
            segs = np.zeros((B, n_pad), np.uint8)
            lengths = np.zeros(B, np.int32)
            for i, w in enumerate(batch):
                segs[i, :len(w.segment)] = w.segment
                lengths[i] = len(w.segment)
            t0 = time.time()
            out = eng.scan_segments_packed(segs, lengths)
            gm = np.asarray(out[0])
            t["scan"] += time.time() - t0
            t0 = time.time()
            packed = (np.asarray(out[2]), np.asarray(out[3]),
                      np.asarray(out[4]))
            t["pack_fetch"] += time.time() - t0
            assert not (gm >= BYTE_SAT).any()
            t0 = time.time()
            peak_parts = []
            from fasim_tpu import native
            for i, w in enumerate(batch):
                # overflow rows (cnt > k) use the driver's full-row
                # fallback in production; clamp here (profiling only)
                cnt = np.minimum(packed[2][i], packed[0].shape[2])
                pk = native.segment_peaks_packed(packed[0][i], packed[1][i],
                                                 cnt)
                if len(pk):
                    peak_parts.append(np.column_stack(
                        [np.full(len(pk), i, np.int64), pk]))
            t["peaks"] += time.time() - t0
            if not peak_parts:
                continue
            peaks = np.concatenate(peak_parts)
            seg_i, scan_i, score, pos = (peaks[:, 0], peaks[:, 1],
                                         peaks[:, 2], peaks[:, 3])
            P = len(peaks)
            cutlens = C.sweep_cutlengths(score, pos)
            nr = cutlens.shape[1]
            m = len(rna)

            def fwd_specs(idx, cl):
                return {
                    "seg_idx": seg_i[idx].astype(np.int32),
                    "scan_idx": scan_i[idx].astype(np.int32),
                    "base": (pos[idx] - cl + 1).astype(np.int32),
                    "dirn": np.ones(len(idx), np.int32),
                    "rlens": cl.astype(np.int32),
                    "offs": np.zeros(len(idx), np.int32),
                    "terms": np.full(len(idx), -1, np.int32),
                    "mreals": np.full(len(idx), m16, np.int32),
                }

            # production two-phase dispatch (mirrors candidate_stage_batch)
            r_best = np.zeros((P, nr), np.int64)
            r_ecol = np.full((P, nr), -1, np.int64)
            r_erow = np.zeros((P, nr), np.int64)
            t0 = time.time()
            out0 = eng.window_pass_specs(
                segs, lengths, fwd_specs(np.arange(P), cutlens[:, 0]),
                rev=False)
            t["fwd"] += time.time() - t0
            r_best[:, 0] = out0[:, 0]
            r_ecol[:, 0] = out0[:, 1]
            r_erow[:, 0] = out0[:, 2]
            nrows = P
            rest = np.flatnonzero(r_best[:, 0] < score)
            if len(rest) and nr > 1:
                uniq = cutlens[rest, 1:] != cutlens[rest, :-1]
                pk_r, rd_r = np.nonzero(uniq)
                pk = rest[pk_r]
                rd = rd_r + 1
                nrows += len(pk)
                t0 = time.time()
                out = eng.window_pass_specs(
                    segs, lengths, fwd_specs(pk, cutlens[pk, rd]),
                    rev=False)
                t["fwd"] += time.time() - t0
                r_best[pk, rd] = out[:, 0]
                r_ecol[pk, rd] = out[:, 1]
                r_erow[pk, rd] = out[:, 2]
                for r in range(1, nr):
                    dup = rest[~uniq[:, r - 1]]
                    r_best[dup, r] = r_best[dup, r - 1]
                    r_ecol[dup, r] = r_ecol[dup, r - 1]
                    r_erow[dup, r] = r_erow[dup, r - 1]
            resolved = np.zeros(P, bool)
            fb_round = np.full(P, -1, np.int64)
            fb_score = np.zeros(P, np.int64)
            for r in range(nr):
                live = np.flatnonzero(~resolved)
                if not len(live):
                    break
                b = r_best[live, r]
                accept = b >= score[live]
                resolved[live[accept]] = True
                fb = (~accept & (b > fb_score[live])
                      & (r_ecol[live, r] == cutlens[live, r] - 1))
                fb_score[live[fb]] = b[fb]
                fb_round[live[fb]] = r
            chosen = np.where(
                resolved, np.argmax(r_best >= score[:, None], axis=1),
                nr - 1)
            unres = ~resolved
            chosen[unres & (fb_round >= 0)] = fb_round[
                unres & (fb_round >= 0)]
            c_best = r_best[np.arange(P), chosen]
            c_ecol = r_ecol[np.arange(P), chosen]
            c_erow = r_erow[np.arange(P), chosen]
            c_cut = cutlens[np.arange(P), chosen]
            wi = np.flatnonzero(c_best != 0)
            lanes = np.where(c_best[wi] >= BYTE_SAT, 8, 16)
            spec_r = {
                "seg_idx": seg_i[wi].astype(np.int32),
                "scan_idx": scan_i[wi].astype(np.int32),
                "base": (pos[wi] - c_cut[wi] + 1
                         + c_ecol[wi]).astype(np.int32),
                "dirn": np.full(len(wi), -1, np.int32),
                "rlens": (c_ecol[wi] + 1).astype(np.int32),
                "offs": (m - 1 - c_erow[wi]).astype(np.int32),
                "terms": c_best[wi].astype(np.int32),
                "mreals": (m + (-(c_erow[wi] + 1)) % lanes
                           ).astype(np.int32),
            }
            t0 = time.time()
            eng.window_pass_specs(segs, lengths, spec_r, rev=True)
            t["rev"] += time.time() - t0
            rows_hist.append((P, nrows, len(wi)))
        wall = time.time() - t_all
        tp, tf, tw = (sum(x) for x in zip(*rows_hist)) if rows_hist else (
            0, 0, 0)
        print(f"rep{rep}: wall={wall:.1f}s "
              + " ".join(f"{k}={v:.1f}" for k, v in t.items())
              + f" peaks={tp} fwd_rows={tf} rev_rows={tw}"
              + f" max_batch_rows={max((b for _, b, _ in rows_hist), default=0)}")


if __name__ == "__main__":
    main()
