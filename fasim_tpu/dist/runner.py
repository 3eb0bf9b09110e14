"""Multi-host distributed scan runner.

The reference is single-process (SURVEY.md §2.b); this is the framework's
own scaling design: one process per host drives all of that host's cards
(its engines round-robin batches over them, as the single-host driver
does).  Every process *streams* the DNA records (one in memory at a
time), takes a round-robin shard of the global
(record, segment) work stream, scans it on its local devices through the
bounded-window driver, and the hit lists are allgathered and merged in
global work order — so the merged result is bit-identical to a
single-host run regardless of process count or completion order, and
per-host memory is O(dispatch window + current record), not O(genome).
Clustering and output run on process 0 only (they are global over the
RNA axis, Fasim-LongTarget.cpp:812).

Collectives: two `process_allgather` rounds (hit-payload lengths, then
padded payloads) over jax.distributed.  Hit payloads are tiny (triplex
records, not colmax arrays), so this gather is latency- not
bandwidth-bound.

Checkpoint/resume (SURVEY.md §5): with `checkpoint_dir` set, each host
spills a pickle per `checkpoint_every` finished work items; a restarted
run reloads the spills and rescans only the remaining shard.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from .. import rules
from ..config import Params
from ..io import fasta
from ..scan.batched import (RecordMeta, _Work, corenum_buckets,
                            finalize_record_into, iter_scan_work)
from ..scan.pipeline import Triplex


# scaling-harness attribution: wall seconds of the last local scan loop
# and of the last allgather, per process (read by runner.main)
LAST_LOCAL_SECONDS = 0.0
LAST_GATHER_SECONDS = 0.0


def _allgather_bytes(payload: bytes) -> list[bytes]:
    """Allgather one bytes object per process via two fixed-shape
    collectives (lengths, then padded uint8 payloads)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import multihost_utils

    n = jax.process_count()
    if n == 1:
        return [payload]
    buf = np.frombuffer(payload, np.uint8)
    lens = np.asarray(multihost_utils.process_allgather(
        jnp.array([len(buf)], jnp.int64))).reshape(-1)
    maxlen = int(lens.max())
    padded = np.zeros(maxlen, np.uint8)
    padded[:len(buf)] = buf
    gathered = np.asarray(multihost_utils.process_allgather(
        jnp.asarray(padded)))
    gathered = gathered.reshape(n, maxlen)
    return [gathered[i, :lens[i]].tobytes() for i in range(n)]


def check_shard_coverage(expected: int, got, nproc: int) -> None:
    """Failed-shard detection: every process streams the same input, so
    process 0 knows the full global work-index set; a host that died
    mid-scan (or lost its checkpoint spills) leaves holes that would
    otherwise produce silently incomplete output.  Raises naming the
    missing shards and their owning process(es) (gidx % nproc)."""
    missing = sorted(set(range(expected)) - set(got))
    if missing:
        owners = sorted({i % nproc for i in missing})
        raise RuntimeError(
            f"distributed scan incomplete: {len(missing)}/{expected} work "
            f"items missing (first: {missing[:8]}), owned by process(es) "
            f"{owners} — rerun with the same FASIM_CKPT to rescan only "
            "the missing shards")


def scan_distributed(p: Params, engine_factory, batch_pairs: int = 32,
                     host_threads: int = 0, checkpoint_dir: str | None = None,
                     checkpoint_every: int = 64, max_inflight: int = 8):
    """Run the sharded streaming scan.  Returns (record_metas, lnc_name,
    rna, all_t) on process 0 and (record_metas, lnc_name, rna, None)
    elsewhere — record_metas are `RecordMeta` (headers + lengths only;
    sequences are never held beyond the current record).

    engine_factory(rna) builds the local scan engines (a list of
    XlaScanEngine, one per local device) — constructed after the query
    is read.
    """
    import jax

    pid = jax.process_index()
    nproc = jax.process_count()
    lnc_name, rna = fasta.read_rna(p.file2path)
    engine = engine_factory(rna)
    scans = rules.scan_list(p.rule, p.strand)

    # checkpoint spills: {gidx: (record_idx, hits)} per finished slice
    my_hits: dict[int, tuple[int, list[Triplex]]] = {}
    if checkpoint_dir:
        os.makedirs(checkpoint_dir, exist_ok=True)
        for name in sorted(os.listdir(checkpoint_dir)):
            # match only this format's spill prefix; older formats (plain
            # hit lists) would silently mis-unpack at the merge
            if name.startswith(f"host{pid}-spill") and name.endswith(".pkl"):
                with open(os.path.join(checkpoint_dir, name), "rb") as f:
                    loaded = pickle.load(f)
                for gidx, payload in loaded.items():
                    if (not isinstance(payload, tuple) or len(payload) != 2
                            or not isinstance(payload[0], int)):
                        raise RuntimeError(
                            f"stale checkpoint format in {name}: expected "
                            "{gidx: (record_idx, hits)} spills — clear "
                            "FASIM_CKPT and rescan")
                    my_hits[gidx] = payload
    done = set(my_hits)
    metas: list[RecordMeta] = []
    n_work = [0]  # total global work items (known after the stream ends)

    def gen():
        gidx = -1
        for rec in fasta.iter_dna(p.file1path):
            metas.append(RecordMeta(rec.species, rec.chro_tag,
                                    rec.start_genome, len(rec.seq)))
            segs, starts = fasta.cut_sequence(rec.seq, p.cut_length,
                                              p.overlap_length)
            for seg, start in zip(segs, starts):
                if fasta.same_seq(seg):
                    continue
                gidx += 1
                n_work[0] = gidx + 1
                if gidx % nproc != pid or gidx in done:
                    continue
                yield _Work(len(metas) - 1, start, seg, gidx)

    n_pad = (p.cut_length + 127) // 128 * 128
    fresh: dict[int, tuple[int, list[Triplex]]] = {}
    n_spill = 0

    def spill():
        nonlocal n_spill
        path = os.path.join(checkpoint_dir,
                            f"host{pid}-spill{n_spill:06d}.pkl")
        n_spill += 1
        while os.path.exists(path):  # resumed run: continue numbering
            path = os.path.join(checkpoint_dir,
                                f"host{pid}-spill{n_spill:06d}.pkl")
            n_spill += 1
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(fresh, f)
        os.replace(tmp, path)

    global LAST_LOCAL_SECONDS, LAST_GATHER_SECONDS
    import time as _time

    t_local = _time.time()
    for w, found in iter_scan_work(p, rna, gen(), scans, engine, n_pad,
                                   batch_pairs, host_threads, max_inflight):
        fresh[w.gidx] = (w.record_idx, found)
        if checkpoint_dir and len(fresh) >= checkpoint_every:
            spill()
            my_hits.update(fresh)
            fresh = {}
    if fresh:
        if checkpoint_dir:
            spill()
        my_hits.update(fresh)
    LAST_LOCAL_SECONDS = _time.time() - t_local

    t_gather = _time.time()
    gathered = _allgather_bytes(pickle.dumps(my_hits))
    LAST_GATHER_SECONDS = _time.time() - t_gather
    if pid != 0:
        return metas, lnc_name, rna, None
    merged: dict[int, tuple[int, list[Triplex]]] = {}
    for blob in gathered:
        merged.update(pickle.loads(blob))
    check_shard_coverage(n_work[0], merged.keys(), nproc)
    # final filter + coordinate fixup + `-C` bucket permutation, in
    # global (record, segment) order — the shared helper keeps this
    # bit-identical to the single-host drivers by construction
    buckets = corenum_buckets(p.corenum)
    per_record: dict[int, list[Triplex]] = {}
    for i in sorted(merged):
        ri, hits = merged[i]
        per_record.setdefault(ri, []).extend(hits)
    for ri in sorted(per_record):
        finalize_record_into(buckets, p, ri, metas[ri], per_record[ri])
    return metas, lnc_name, rna, [t for b in buckets for t in b]


def main(argv=None) -> int:
    """Process entry: initialize jax.distributed from env/flags and run.

    Env: FASIM_COORD (host:port), FASIM_NPROC, FASIM_PID give the
    cluster topology (nothing on a GPU host describes it); without
    FASIM_COORD the runner is one process driving every local card.
    """
    import sys

    import jax

    from ..cli import make_engine, parse_args
    from ..post.output import print_result
    from ..runtime import enable_compile_cache

    if os.environ.get("FASIM_CPU_PIN"):
        # scaling harness: pin each loopback worker to one core so the
        # XLA-CPU intra-op pool (sized to all cores) cannot thrash across
        # processes and the speedup measures framework overhead
        ncpu = os.cpu_count() or 1
        os.sched_setaffinity(
            0, {int(os.environ.get("FASIM_PID", "0")) % ncpu})
    p, cfg = parse_args(sys.argv[1:] if argv is None else argv)
    enable_compile_cache()
    coord = os.environ.get("FASIM_COORD")
    if coord:
        jax.distributed.initialize(
            coordinator_address=coord,
            num_processes=int(os.environ["FASIM_NPROC"]),
            process_id=int(os.environ["FASIM_PID"]))
    host_threads = int(os.environ.get("FASIM_HOST_THREADS", "0"))
    reps = int(os.environ.get("FASIM_SCALING_REPS", "1"))
    engine_factory = lambda r: make_engine(cfg, r)  # noqa: E731
    for rep in range(reps):
        # scaling harness: repeat the scan so rep > 0 measures the warm
        # (compile-amortized) steady state; results are identical
        import time as _time

        t0 = _time.time()
        records, lnc_name, rna, all_t = scan_distributed(
            p, engine_factory, batch_pairs=cfg.segments_per_batch,
            host_threads=host_threads,
            checkpoint_dir=(os.environ.get("FASIM_CKPT") or None)
            if reps == 1 else None, max_inflight=cfg.max_inflight)
        if reps > 1:
            # every process reports: the harness attributes efficiency
            # loss to load imbalance (local spread) vs gather overhead
            print(f"FASIM_SCAN_SECONDS rep={rep} pid={jax.process_index()}"
                  f" total={_time.time() - t0:.3f}"
                  f" local={LAST_LOCAL_SECONDS:.3f}"
                  f" gather={LAST_GATHER_SECONDS:.3f}", flush=True)
    if jax.process_index() == 0:
        first = records[0]
        print_result(p, first.species, lnc_name, all_t, first.chro_tag,
                     first.seq_len, first.start_genome)
        print("finished normally")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
