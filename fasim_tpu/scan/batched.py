"""Batched device scan driver.

The per-segment pipeline in `pipeline.py` calls the engine once per
segment (48 transforms).  At genome scale that leaves the device idle
between tiny calls: this driver groups segments into fixed-size batches,
the engine runs all rule transforms of a batch in one device call and
returns (threshold, clamped-uint8 colmax, packed candidate columns), and
the host candidate stage runs per segment on the results.

Scaling design (the reference is single-threaded, SURVEY.md §2.b):

  * **Streaming with a bounded dispatch window**: at most `max_inflight`
    device batches are in flight per device, so host + device memory is
    O(window), not O(genome).
  * **Multi-card**: independent batches round-robin across one engine per
    local device.  Segments are embarrassingly parallel (the overlapping
    segmentation makes alignments local by construction, fastsim.h:71-90),
    so no collectives are needed; each card runs its own stream.
  * Device work overlaps the host candidate stage (a stage thread per
    in-flight batch + a host thread pool; the native candidate call
    releases the GIL).

Results are bit-identical to the sequential pipeline: batching only
reorders *independent* device computations, and the host stage consumes
them in (record, segment, transform) order — the reference's iteration
order (Fasim-LongTarget.cpp:133-163, :395) — regardless of device count,
window size, or completion order.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import native, rules
from ..config import GAP_EXTEND, GAP_OPEN, Params
from ..io import fasta
from ..profiling import STAGES
from .pipeline import Triplex, _sim

# glibc heap knobs for the long streamed runs: freed short-lived host
# mirrors (colmax rows, packed candidates) otherwise keep RSS growing
# with the genome length.  The arena cap
# must be applied BEFORE any worker thread exists — arenas created
# earlier escape it — so it runs at module import, not inside the
# driver (which already has compile/stage threads by then).
try:
    import ctypes

    _LIBC = ctypes.CDLL("libc.so.6")
    _LIBC.mallopt(-8, 4)  # M_ARENA_MAX
except OSError:
    _LIBC = None


def pin_mmap_threshold() -> None:
    """Pin glibc's mmap threshold (streaming/genome runs): glibc
    otherwise raises it dynamically (up to 32 MB) after the first large
    frees, after which every MB-sized host mirror lands on the heap and
    freed pages are never returned.  With >= 256 KB allocations mmap'ed,
    frees munmap immediately and peak RSS is O(live set), but the host
    finalize then pays mmap page faults on every reused buffer; on a
    streamed 100 Mb run that cost far more wall time than the small RSS
    drop was worth, so this is opt-in (FASIM_MMAP_PIN=1)."""
    if _LIBC is not None and os.environ.get("FASIM_MMAP_PIN") == "1":
        _LIBC.mallopt(-3, 1 << 18)  # M_MMAP_THRESHOLD


_SIM_POOL = None


def _sim_pool() -> ThreadPoolExecutor:
    """Shared executor for the exact-SIM (-F) pair fan-out; the native
    scan releases the GIL, so pairs run truly concurrently.  Module
    level (not per segment) so total concurrency stays bounded at the
    core count even when several segments are in flight."""
    global _SIM_POOL
    if _SIM_POOL is None:
        _SIM_POOL = ThreadPoolExecutor(
            max_workers=max(1, os.cpu_count() or 1),
            thread_name_prefix="fasim-sim")
    return _SIM_POOL


@dataclasses.dataclass
class _Work:
    """One (record, segment) pair queued for the device scan."""

    record_idx: int
    start: int  # dnaStartPos of the segment within the record
    segment: np.ndarray
    gidx: int = -1  # global work index (distributed sharding/merge key)


def enumerate_work(p: Params, records) -> tuple[list[_Work], list[dict]]:
    scans = rules.scan_list(p.rule, p.strand)
    work: list[_Work] = []
    for ri, rec in enumerate(records):
        segs, starts = fasta.cut_sequence(rec.seq, p.cut_length,
                                          p.overlap_length)
        for seg, start in zip(segs, starts):
            if fasta.same_seq(seg):
                continue
            work.append(_Work(ri, start, seg))
    return work, scans


_SRC_KINDS = ("fwd", "revcomp", "comp", "rev")


class _ScanMeta:
    """Per-run scan metadata arrays for the native segment stage."""

    def __init__(self, scans: list[dict]):
        t = len(scans)
        self.scans = scans
        self.luts = np.empty((t, 256), np.uint8)
        self.xform_rev = np.empty(t, np.int8)
        self.src_sel = np.empty(t, np.int8)
        self.strands = np.empty(t, np.int32)
        self.paras = np.empty(t, np.int32)
        for k, s in enumerate(scans):
            self.luts[k] = rules.transfer_lut(s["strand"], s["para"],
                                              s["rule"])
            self.xform_rev[k] = s["xform"] == "tr"
            self.src_sel[k] = _SRC_KINDS.index(s["src"])
            self.strands[k] = s["strand"]
            self.paras[k] = s["para"]
        self.ssw_enc = np.ascontiguousarray(rules.SSW_ENC, np.int8)
        self.ssw_enc_u8 = rules.SSW_ENC.astype(np.uint8)
        self.mat = np.ascontiguousarray(rules.SSW_MAT, np.int32)


def _host_segment_stage(p: Params, rna: np.ndarray, q_idx: np.ndarray,
                        rna_b: bytes, meta: _ScanMeta, w: _Work,
                        gm_row: np.ndarray, cm_seg: np.ndarray,
                        cm_stride: int) -> list[Triplex]:
    """Host candidate stage for one segment (all transforms), in the
    reference's transform order.  Runs on a worker thread: the native
    segment call releases the GIL, so segments proceed in parallel."""
    with STAGES.timer("host_candidate_busy"):
        return _host_segment_stage_inner(p, rna, q_idx, rna_b, meta, w,
                                         gm_row, cm_seg, cm_stride)


def _host_segment_stage_inner(p: Params, rna: np.ndarray, q_idx: np.ndarray,
                              rna_b: bytes, meta: _ScanMeta, w: _Work,
                              gm_row: np.ndarray, cm_seg: np.ndarray,
                              cm_stride: int) -> list[Triplex]:
    scans = meta.scans
    if not p.do_fast_sim:
        # exact SIM path: per-pair native calls (no colmax gating).
        # FASIM_SIM_DEVICE=1 runs the forward scan (sim.h:511-567) on
        # the device (kernels/sim_dev.py) and replays the qualifying
        # cells through the host node list — bit-identical by the
        # test_sim differential; the packed-start encoding needs
        # (M+1)(N+2) < 2^31 (host path otherwise).
        found: list[Triplex] = []
        pairs = [rules.make_scan_strings(w.segment, s) for s in scans]
        n = len(w.segment)
        m = len(rna)
        use_dev = (os.environ.get("FASIM_SIM_DEVICE", "0") == "1"
                   and (m + 1) * (n + 2) < 2 ** 31)
        if use_dev:
            from ..kernels.sim_dev import sim_forward_cells

            f32_ = np.float32
            mp = (m + 7) // 8 * 8
            # bound the fetched (N, Tg, mp) int32 x2 matrices to ~256 MB
            tg = max(1, min(8, (256 << 20) // max(1, n * mp * 8)))
            rna_bt = rna.tobytes()
            for lo in range(0, len(scans), tg):
                grp = range(lo, min(lo + tg, len(scans)))
                mins = [int(int(gm_row[k]) * 0.8) for k in grp]
                cells = sim_forward_cells(
                    rna, [pairs[k][0] for k in grp], mins)
                for gi, k in enumerate(grp):
                    scan = scans[k]
                    for (stari, endi, starj, endj, nt, score, ident,
                         tri, ri, rj) in native.sim_scan_replay(
                            rna_bt, pairs[k][0].tobytes(),
                            pairs[k][1].tobytes(), w.start, mins[gi],
                            scan["strand"], scan["para"], p.nt_min,
                            p.nt_max, p.penalty_t, p.penalty_c,
                            cells[gi]):
                        found.append(Triplex(
                            stari=stari, endi=endi, starj=starj,
                            endj=endj, strand=scan["strand"],
                            reverse=scan["para"], rule=scan["rule"],
                            nt=nt, score=f32_(score),
                            identity=f32_(ident), tri_score=f32_(tri),
                            stri_align=ri, strj_align=rj))
            return found
        # the 48 (segment, transform) pairs are fully independent (each
        # owns its node list / used-cell state, sim.h:410-1143); run
        # them across cores and concatenate in scan order — the
        # reference's iteration order, so output is bit-identical.
        # The reference runs this loop on one core (SURVEY §2.b).
        def one(k):
            scan = scans[k]
            min_score = int(int(gm_row[k]) * 0.8)
            part: list[Triplex] = []
            _sim(rna, pairs[k][0], pairs[k][1], w.start, min_score,
                 scan["strand"], scan["para"], scan["rule"], p, part)
            return part

        ex = _sim_pool()
        for part in ex.map(one, range(len(scans))):
            found.extend(part)
        return found
    seg = w.segment
    srcs = [seg, rules.reverse(rules.complement(seg)),
            rules.complement(seg), rules.reverse(seg)]
    src_bytes = [np.ascontiguousarray(s).tobytes() for s in srcs]
    src_lens = np.array([len(s) for s in src_bytes], np.int64)
    rows = native.fastsim_segment(
        q_idx, rna_b, seg.tobytes(), src_bytes, src_lens, meta.src_sel,
        meta.luts, meta.xform_rev, meta.strands, meta.paras, meta.ssw_enc,
        cm_seg, cm_stride, np.ascontiguousarray(gm_row, np.int32),
        meta.mat, GAP_OPEN, GAP_EXTEND, w.start, p.nt_min, p.nt_max,
        p.penalty_t, p.penalty_c, np.float32(p.min_identity),
        np.float32(p.min_stability))
    f32 = np.float32
    return [Triplex(stari=r[1], endi=r[2], starj=r[3], endj=r[4],
                    strand=scans[r[0]]["strand"], reverse=scans[r[0]]["para"],
                    rule=scans[r[0]]["rule"], nt=r[5], score=f32(r[6]),
                    identity=f32(r[7]), tri_score=f32(r[8]),
                    stri_align=r[9], strj_align=r[10])
            for r in rows]


def scan_records(p: Params, records, rna: np.ndarray, engine,
                 batch_pairs: int = 32, host_threads: int = 0,
                 max_inflight: int = 8) -> list[list[Triplex]]:
    """Run the full scan for all records; returns one triplex list per
    record (pre genome-coordinate fixup), matching long_target's output."""
    work, scans = enumerate_work(p, records)
    out: list[list[Triplex]] = [[] for _ in records]
    for w, found in scan_work(p, rna, work, scans, engine, batch_pairs,
                              host_threads, max_inflight):
        out[w.record_idx].extend(found)
    return out


def scan_work(p: Params, rna: np.ndarray, work: list[_Work],
              scans: list[dict], engine, batch_pairs: int = 32,
              host_threads: int = 0, max_inflight: int = 8
              ) -> list[tuple[_Work, list[Triplex]]]:
    """Scan an explicit work list; returns (work item, hits) pairs in the
    given order.  This is the shard-level entry the distributed runner
    feeds with one host's subset of segments.  List-input wrapper around
    `iter_scan_work`."""
    if not work:
        if engine is not None:
            (engine[0] if isinstance(engine, (list, tuple))
             else engine).setup_scans(scans)
        return []
    n_max = max(len(w.segment) for w in work)
    n_pad = (n_max + 127) // 128 * 128
    return list(iter_scan_work(p, rna, iter(work), scans, engine, n_pad,
                               batch_pairs, host_threads, max_inflight,
                               n_work_hint=len(work)))


def iter_scan_work(p: Params, rna: np.ndarray, work_iter, scans: list[dict],
                   engine, n_pad: int, batch_pairs: int = 32,
                   host_threads: int = 0, max_inflight: int = 8,
                   n_work_hint: int = -1):
    """Streaming scan core: consume a lazy work iterator, keep at most
    `max_inflight` device batches in flight per device, yield (work item,
    hits) in input order.

    `engine` is one engine or a list of per-device engines (one per local
    chip); batches round-robin across them.  Each engine must expose
    setup_scans/scan_segments (kernels.xla.XlaScanEngine); the NumPy
    fallback path lives in pipeline.long_target.  Because segments are
    independent and results are yielded in input order, the output is
    bit-identical for any device count, window size, or thread count.
    """
    engines = list(engine) if isinstance(engine, (list, tuple)) else [engine]
    for e in engines:
        e.setup_scans(scans)
    if host_threads <= 0:
        host_threads = min(32, os.cpu_count() or 1)
    if max_inflight <= 0:
        max_inflight = 1 << 30
    max_inflight = max(max_inflight, 2) * len(engines)
    host_backlog = min(2 * max_inflight, 256)

    meta = _ScanMeta(scans)
    q_idx = np.ascontiguousarray(rules.SSW_ENC[rna], np.int32)
    rna_b = rna.tobytes()
    inflight: collections.deque = collections.deque()
    done: collections.deque = collections.deque()
    use_windows = p.do_fast_sim
    if use_windows:
        from .candidates import candidate_stage_batch

        for e in engines:
            e.setup_windows(rna)
    # one stage thread per in-flight batch: device scans and the
    # candidate stage's window passes overlap across batches and cards
    # stage workers are capped: with max_inflight=0 ("dispatch everything
    # up front") the inflight window is effectively unbounded, but one OS
    # thread per batch would not be
    with ThreadPoolExecutor(max_workers=host_threads) as pool, \
            ThreadPoolExecutor(
                max_workers=max(2, min(64, max_inflight))) as stages:

        def process_batch(batch, segs, lengths, eng):
            # the device scan runs here, on the batch's stage thread, so
            # batches on different cards (and the host stage of earlier
            # batches) overlap, and the watchdog bounds the scan too
            with STAGES.timer("device_scan"):
                if use_windows:
                    out = eng.scan_segments_packed(segs, lengths)
                else:
                    out = eng.scan_segments(segs, lengths)
            gm, cm = out[0], out[1]

            def cm_get(sel):
                # full colmax rows (int or advanced-index tuple) for the
                # candidate stage's overflow rows
                return cm[sel]

            def cm_fallback(i):
                # banded-traceback-error fallback (never observed)
                return cm[i]

            packed = tuple(out[2:5]) if len(out) > 2 else None
            if use_windows:
                return candidate_stage_batch(
                    p, rna, q_idx, rna_b, meta, batch, segs, lengths,
                    gm, cm_get, packed, eng, pool,
                    cm_fallback=cm_fallback)
            stride = cm.shape[2]
            return [(w, pool.submit(
                _host_segment_stage, p, rna, q_idx, rna_b, meta, w,
                gm[i], cm[i], stride)) for i, w in enumerate(batch)]

        # Watchdog: a device call or host task that never returns (a hung
        # kernel, a lost device) would otherwise block the run forever.
        # Cap every blocking wait so a wedged batch surfaces as a clear
        # error instead of an indefinite hang; the bound must cover the
        # slowest cold compile of a batch's shapes.
        wd = float(os.environ.get("FASIM_WATCHDOG_S", "1800"))

        def _result(fut, what: str):
            from concurrent.futures import TimeoutError as FutTimeout

            try:
                return fut.result(timeout=wd)
            except FutTimeout:
                raise RuntimeError(
                    f"scan watchdog: {what} made no progress for {wd:.0f}s"
                    " — device/backend likely wedged; rerun (checkpointed"
                    " runs resume via FASIM_CKPT)") from None

        def consume_oldest():
            stage_fut = inflight.popleft()
            done.append(stage_fut)

        def drain_done(min_keep: int):
            # pop completed stage batches (in order); block on the oldest
            # while more than min_keep are queued
            while done and (len(done) > min_keep or done[0].done()):
                for w0, fut in _result(done.popleft(), "a device batch"):
                    with STAGES.timer("host_candidate_wait"):
                        hits = _result(fut, "a host finalize task")
                    yield w0, hits

        def dispatch(batch, k):
            # a partial batch is trimmed to its real segment count: one
            # extra compiled shape instead of DP over padding segments
            segs = np.zeros((len(batch), n_pad), np.uint8)
            lengths = np.zeros(len(batch), np.int32)
            for i, w in enumerate(batch):
                segs[i, :len(w.segment)] = w.segment
                lengths[i] = len(w.segment)
            inflight.append(stages.submit(
                process_batch, batch, segs, lengths,
                engines[k % len(engines)]))

        # (the M_ARENA_MAX cap is applied at module import, before any
        # worker thread exists; here we only return free heap to the OS
        # every few batches)
        nbatch = 0
        batch: list[_Work] = []
        for w in work_iter:
            batch.append(w)
            if len(batch) < batch_pairs:
                continue
            if len(inflight) >= max_inflight:
                consume_oldest()
            yield from drain_done(min_keep=host_backlog)
            dispatch(batch, nbatch)
            nbatch += 1
            if _LIBC is not None and nbatch % 8 == 0:
                _LIBC.malloc_trim(0)
            batch = []
        if batch:
            if len(inflight) >= max_inflight:
                consume_oldest()
            dispatch(batch, nbatch)
        while inflight:
            consume_oldest()
        yield from drain_done(min_keep=0)


def corenum_buckets(n: int) -> list[list[Triplex]]:
    """Bucket list emulating the reference's `-C corenum` round-robin:
    record i's triplexes append to bucket i % corenum, and the final
    list is the buckets concatenated in bucket order (Fasim-LongTarget.
    cpp:129-163 — no threads are ever spawned, but the permutation
    changes TFOsorted row order within sort-tie classes because the
    class sort is non-stable on pre-sort order, :813,:847-850)."""
    return [[] for _ in range(max(1, n))]


def filter_fix_record(p: Params, rec, lst: list[Triplex]) -> list[Triplex]:
    """Final per-record filter (Fasim-LongTarget.cpp:589-597) +
    genome-coordinate fixup (main:141-149) for one record's hits; rec
    needs only .chro_tag / .start_genome."""
    f32 = np.float32
    lst = [t for t in lst
           if (t.score >= f32(p.score_min)
               and t.identity >= f32(p.min_identity)
               and t.tri_score >= f32(p.min_stability)
               and t.nt >= p.c_length)]
    for t in lst:
        if t.genomestart == 0:
            t.chr = rec.chro_tag
            t.genomestart = t.starj + rec.start_genome - 1
            t.genomeend = t.endj + rec.start_genome - 1
    return lst


def finalize_record_into(buckets: list[list[Triplex]], p: Params, ri: int,
                         rec, lst: list[Triplex]) -> None:
    """filter_fix_record + `-C` bucket append — the single
    implementation shared by the batched, streaming and distributed
    drivers (their outputs must stay bit-identical)."""
    buckets[ri % len(buckets)].extend(filter_fix_record(p, rec, lst))


def finalize_records(p: Params, records, per_record: list[list[Triplex]]
                     ) -> list[Triplex]:
    """Final filter then genome-coordinate fixup, concatenated in record
    order — through the `-C` bucket permutation when corenum >= 2."""
    buckets = corenum_buckets(p.corenum)
    for i, (rec, lst) in enumerate(zip(records, per_record)):
        finalize_record_into(buckets, p, i, rec, lst)
    return [t for b in buckets for t in b]


def scan_file_batched(p: Params, engine, batch_pairs: int = 32,
                      host_threads: int = 0, max_inflight: int = 8):
    """Batched equivalent of pipeline.scan_file: same return contract."""
    records = fasta.read_dna(p.file1path)
    lnc_name, rna = fasta.read_rna(p.file2path)
    per_record = scan_records(p, records, rna, engine, batch_pairs,
                              host_threads, max_inflight)
    return records, lnc_name, rna, finalize_records(p, records, per_record)


@dataclasses.dataclass
class RecordMeta:
    """Header metadata of a streamed record (sequence dropped)."""

    species: str
    chro_tag: str
    start_genome: int
    seq_len: int


def scan_file_stream(p: Params, engine, batch_pairs: int = 64,
                     host_threads: int = 0, max_inflight: int = 8,
                     spill_dir: str | None = None):
    """Genome-scale streaming scan: records read lazily (one in memory at
    a time), segments flow through the bounded-window driver, and each
    record's hits are filtered + coordinate-fixed as soon as the record
    completes, then appended to a columnar TriplexStore (numeric columns
    in RAM at ~60 B/hit; with `spill_dir` set — default TMPDIR — the
    alignment strings spill to disk until TFOsorted-write time).  Memory
    is O(dispatch window + current record + numeric hit columns), not
    O(genome).  Returns (record_metas, lnc_name, rna, store) — the store
    yields byte-identical output files to scan_file_batched's list via
    post.output.print_result (tests/test_batched_driver.py)."""
    from ..post.store import TriplexStore

    pin_mmap_threshold()
    lnc_name, rna = fasta.read_rna(p.file2path)
    metas: list[RecordMeta] = []

    def gen():
        for ri, rec in enumerate(fasta.iter_dna(p.file1path)):
            metas.append(RecordMeta(rec.species, rec.chro_tag,
                                    rec.start_genome, len(rec.seq)))
            segs, starts = fasta.cut_sequence(rec.seq, p.cut_length,
                                              p.overlap_length)
            for seg, start in zip(segs, starts):
                if fasta.same_seq(seg):
                    continue
                yield _Work(ri, start, seg)

    scans = rules.scan_list(p.rule, p.strand)
    n_pad = (p.cut_length + 127) // 128 * 128
    nbuckets = max(1, p.corenum)
    if spill_dir is None:
        spill_dir = os.environ.get("FASIM_SPILL_DIR",
                                   tempfile.gettempdir())
    store = TriplexStore(spill_dir=spill_dir or None)

    def flush(ri: int, lst: list[Triplex]) -> None:
        store.add_record(ri % nbuckets, metas[ri].chro_tag,
                         filter_fix_record(p, metas[ri], lst))

    cur_ri = -1
    cur: list[Triplex] = []
    for w, found in iter_scan_work(p, rna, gen(), scans, engine, n_pad,
                                   batch_pairs, host_threads,
                                   max_inflight):
        if w.record_idx != cur_ri:
            if cur_ri >= 0:
                flush(cur_ri, cur)
            cur_ri = w.record_idx
            cur = []
        cur.extend(found)
    if cur_ri >= 0:
        flush(cur_ri, cur)
    return metas, lnc_name, rna, store.finalize()
