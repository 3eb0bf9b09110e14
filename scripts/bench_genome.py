"""Synthetic genome-scale scan benchmark (BASELINE.json config 4).

Generates a synthetic multi-record chromosome (~--mb megabases of random
ACGT with planted query homologies so the candidate stage does real
work), streams it through the genome driver (scan_file_stream: lazy
records, bounded dispatch window), and reports Mb/s + peak RSS:

    python scripts/bench_genome.py [--mb=10] [--rna=oracle/MEG3.fa]
                                   [--round=2]

Writes GENOME_r<N>.json at the repo root.  The reference's measured rate
is ~0.017 Mb/s for a 1.6 knt query (BASELINE.md) — 4-5 core-days for a
human genome.
"""

import json
import os
import resource
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np


def synth_genome(path: str, mb: float, rna: np.ndarray, seed: int = 0):
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    total = int(mb * 1e6)
    rec_len = 5_000_000
    written = 0
    with open(path, "w") as f:
        ri = 0
        while written < total:
            n = min(rec_len, total - written)
            seq = bases[rng.integers(0, 4, n)]
            # plant ~1 homology per 50 kb so hits and clusters exist
            for _ in range(max(1, n // 50_000)):
                lo = int(rng.integers(0, max(1, n - 400)))
                ql = int(rng.integers(60, min(300, len(rna))))
                qs = int(rng.integers(0, len(rna) - ql))
                piece = rna[qs:qs + ql].copy()
                muts = rng.random(ql) < 0.1
                piece[muts] = bases[rng.integers(0, 4, int(muts.sum()))]
                seq[lo:lo + ql] = piece
            f.write(f">synt|chr{ri + 1}|{written + 1}-{written + n}\n")
            s = seq.tobytes().decode("latin-1")
            for i in range(0, n, 80):
                f.write(s[i:i + 80] + "\n")
            written += n
            ri += 1
    return written


def main() -> int:
    mb = float(next((a.split("=")[1] for a in sys.argv
                     if a.startswith("--mb=")), "10"))
    rna_path = next((a.split("=")[1] for a in sys.argv
                     if a.startswith("--rna=")), "oracle/MEG3.fa")
    rnd = next((a.split("=")[1] for a in sys.argv
                if a.startswith("--round=")), "NN")

    from fasim_tpu.cli import make_engine
    from fasim_tpu.config import Params, TpuConfig
    from fasim_tpu.io import fasta
    from fasim_tpu.post.output import print_result
    from fasim_tpu.profiling import STAGES
    from fasim_tpu.scan.batched import scan_file_stream

    # glibc creates one malloc arena per thread by default; with ~32 host
    # worker threads the arena slack alone inflates RSS by GBs on a
    # long-running scan.  Cap arenas before any worker thread exists.
    import ctypes

    try:
        ctypes.CDLL("libc.so.6").mallopt(-8, 4)  # M_ARENA_MAX = 4
    except OSError:
        pass

    _, rna = fasta.read_rna(os.path.join(REPO, rna_path))
    prev_cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as td:
        # run from the temp dir with a relative -f1: the reference embeds
        # the f1 path in output filenames (fileName quirk), so an
        # absolute path would produce an invalid nested output path
        os.chdir(td)
        dna = "synth.fa"
        print(f"generating {mb} Mb synthetic genome ...")
        total = synth_genome(dna, mb, rna)
        out = os.path.join(td, "out")
        os.mkdir(out)
        p = Params(file1path=dna, file2path=os.path.join(REPO, rna_path),
                   outpath=out)
        cfg = TpuConfig()
        engines = make_engine(cfg, rna)
        # warm-up pre-pass on a small slice: kernel compiles belong to
        # process startup, not the steady-state Mb/s a genome-length run
        # sees
        warm_dna = os.path.join(td, "warm.fa")
        synth_genome(warm_dna, 0.5, rna, seed=1)
        warm_out = os.path.join(td, "warm_out")
        os.mkdir(warm_out)
        scan_file_stream(Params(file1path=warm_dna, file2path=p.file2path,
                                outpath=warm_out), engines,
                         batch_pairs=cfg.segments_per_batch,
                         max_inflight=cfg.max_inflight)
        STAGES.start_run()

        # RSS attribution sampler: RSS (MB) every 2 s, tagged with the
        # phase, so the peak can be attributed (scan loop vs output)
        import threading

        rss_samples: list[tuple[float, float, str]] = []
        phase = ["scan"]
        stop_evt = threading.Event()

        def _rss_now() -> float:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        return int(line.split()[1]) / 1024.0
            return 0.0

        def sampler():
            t_start = time.time()
            while not stop_evt.wait(2.0):
                rss_samples.append((round(time.time() - t_start, 1),
                                    round(_rss_now(), 1), phase[0]))

        threading.Thread(target=sampler, daemon=True).start()
        t0 = time.time()
        metas, lnc, _, tlist = scan_file_stream(
            p, engines, batch_pairs=cfg.segments_per_batch,
            max_inflight=cfg.max_inflight)
        phase[0] = "post"
        rss_scan_end = _rss_now()
        first = metas[0]
        print_result(p, first.species, lnc, tlist, first.chro_tag,
                     first.seq_len, first.start_genome)
        stop_evt.set()
        rss_post_end = _rss_now()
        dt = time.time() - t0
        nrows = sum(1 for f in os.listdir(out) for _ in open(
            os.path.join(out, f)))
        os.chdir(prev_cwd)
    rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    res = {
        "mb": total / 1e6,
        "wall_s": round(dt, 1),
        "mb_per_s": round(total / 1e6 / dt, 4),
        "vs_reference_0.017": round(total / 1e6 / dt / 0.0165, 1),
        "hits": len(tlist),
        "output_rows": nrows,
        "peak_rss_mb": round(rss_mb, 1),
        "rss_scan_end_mb": round(rss_scan_end, 1),
        "rss_post_end_mb": round(rss_post_end, 1),
        "rss_peak_by_phase_mb": {
            ph: max((r for _, r, p2 in rss_samples if p2 == ph),
                    default=0.0)
            for ph in ("scan", "post")},
        "stages": {k: v for k, v in STAGES.report().items()
                   if not k.startswith("n_")},
    }
    print(json.dumps(res))
    path = os.path.join(REPO, f"GENOME_r{rnd}.json")
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    print("->", path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
