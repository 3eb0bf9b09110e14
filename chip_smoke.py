"""Smoke run of the triplex scan on an NVIDIA GPU, end to end, at real size.

    python chip_smoke.py               # one card: phases 0-2
    python chip_smoke.py --four-cards  # only the multi-card phase (4 cards)

Everything runs in this one process (a second JAX process on the card
would find its memory taken); only nvidia-smi and the compilers run as
children.  Phases, each fatal on failure:

  0. device and set-up: a GPU is required; prints the card, its power
     limit, versions and the compile cache, builds the native and CUDA
     libraries;
  1. kernel parity at real widths: the CUDA scan (colmax) and window
     kernels against the plain XLA passes, exactly, at the MEG3 and NEAT1
     batch shapes, plus sampled rows against the NumPy goldens; prints
     each step's memory_analysis() and the kernel-vs-XLA timing in turns;
  2. end to end: five CLI runs (fasim_tpu.cli.main, in-process) whose
     output files must be byte-identical to oracle/golden/<case>/.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import filecmp
import json
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
ORACLE = os.path.join(REPO, "oracle")
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

# (case, -f1, -f2, extra flags) — the committed golden matrix
E2E_CASES = [
    ("meg3_full", "meg3dna.fa", "MEG3.fa", []),
    ("neat1", "testDNA.fa", "NEAT1.fa", []),
    ("malat1", "testDNA.fa", "MALAT1.fa", []),
    ("h19_lg40", "testDNA.fa", "H19.fa", ["-lg", "40"]),
    ("h19_F", "testDNA.fa", "H19.fa",
     ["-F", "-lg", "40", "--tpu-sim-device", "true"]),
]


def card() -> str:
    """'<name>, <power limit>' of the first card, as nvidia-smi says."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def _timed(fn, *args, **kw):
    import jax

    t = time.perf_counter()
    out = jax.block_until_ready(fn(*args, **kw))
    return out, time.perf_counter() - t


def _turns(name, ref, ker, args, kw_ref, kw_ker, tag):
    """Time the XLA step and the kernel in turns (XLA, kernel, kernel,
    XLA) on resident inputs, after one warm-up call of each."""
    _timed(ref, *args[0], **kw_ref)
    _timed(ker, *args[1], **kw_ker)
    t = {"xla": [], "cuda": []}
    for which in ("xla", "cuda", "cuda", "xla"):
        fn, a, kw = ((ref, args[0], kw_ref) if which == "xla"
                     else (ker, args[1], kw_ker))
        t[which].append(_timed(fn, *a, **kw)[1])
    print(f"timing {name} [{tag}]: xla {[f'{x * 1e3:.3f}' for x in t['xla']]}"
          f" ms, cuda {[f'{x * 1e3:.3f}' for x in t['cuda']]} ms, "
          f"xla/cuda {min(t['xla']) / min(t['cuda']):.1f}x", flush=True)


def _memory(name, fn, *args, **kw):
    ma = fn.lower(*args, **kw).compile().memory_analysis()
    print(f"memory_analysis {name}: argument={ma.argument_size_in_bytes} "
          f"output={ma.output_size_in_bytes} temp={ma.temp_size_in_bytes} "
          f"code={ma.generated_code_size_in_bytes} bytes", flush=True)


def _segments(n_segs: int, n: int):
    """A real segment batch uint8[S, n] from the MEG3 DNA records."""
    from fasim_tpu.io import fasta

    recs = fasta.read_dna(os.path.join(ORACLE, "meg3dna.fa"))[:n_segs]
    segs = np.zeros((len(recs), n), np.uint8)
    lengths = np.zeros(len(recs), np.int32)
    for i, r in enumerate(recs):
        k = min(len(r.seq), n)
        segs[i, :k] = r.seq[:k]
        lengths[i] = k
    return segs, lengths


def check_colmax(device, query: str, n_segs: int = 64, n: int = 5120,
                 timing: bool = False) -> None:
    """CUDA colmax == colmax_xla exactly on a real (segment, transform)
    batch against `query`, both alphabets; sampled rows == NumPy golden."""
    import jax

    from fasim_tpu import rules
    from fasim_tpu.io import fasta
    from fasim_tpu.kernels import gpu
    from fasim_tpu.kernels.batch_np import _batched_colmax_and_max
    from fasim_tpu.kernels.xla import XlaScanEngine, colmax_xla

    _, rna = fasta.read_rna(os.path.join(ORACLE, query))
    eng = XlaScanEngine(rna, device=device)
    eng.setup_scans(rules.scan_list(0, 0))
    segs, lengths = _segments(n_segs, n)
    tag = f"{query} {len(segs)}x48x{n}, m={len(rna)}"
    for which, matq, mat, enc in (
            ("ssw", eng.matq_ssw, rules.SSW_MAT, rules.SSW_ENC),
            ("thresh", eng.matq_thresh, rules.THRESH_MAT, rules.THRESH_ENC)):
        codes = eng.transform_codes(segs, lengths, which)
        c32 = jax.device_put(codes.astype(np.int32), device)
        c8 = jax.device_put(codes, device)
        ref, t_ref = _timed(colmax_xla, c32, matq, m16=eng.m16)
        got, t_ker = _timed(gpu.colmax_cuda, c8, matq, m16=eng.m16)
        ref, got = np.asarray(ref), np.asarray(got)
        if not np.array_equal(ref, got):
            bad = np.argwhere(ref != got)
            raise AssertionError(f"colmax {which} [{tag}]: {len(bad)} cells "
                                 f"differ, first {bad[:4].tolist()}")
        for s, t in ((0, 0), (len(segs) - 1, 47)):
            _, golden = _batched_colmax_and_max(
                enc[rna], codes[s, t][None].astype(np.int64), mat, 16,
                False)
            if not np.array_equal(golden[0], got[s, t]):
                raise AssertionError(f"colmax {which} [{tag}] row {(s, t)} "
                                     "differs from the NumPy golden")
        print(f"colmax {which} [{tag}]: exact vs colmax_xla and 2 golden "
              f"rows (first calls: xla {t_ref:.3f} s, cuda {t_ker:.3f} s)",
              flush=True)
        if timing and which == "ssw":
            _memory(f"colmax_xla [{tag}]", colmax_xla, c32, matq,
                    m16=eng.m16)
            _memory(f"colmax_cuda [{tag}]", gpu.colmax_cuda, c8, matq,
                    m16=eng.m16)
            _turns("colmax", colmax_xla, gpu.colmax_cuda,
                   ((c32, matq), (c8, matq)), {"m16": eng.m16},
                   {"m16": eng.m16}, tag)


def check_window(device, query: str, n_rows: int = 4096,
                 timing: bool = False) -> None:
    """CUDA window pass == window_pass_xla exactly on candidate-shaped
    windows against `query`: forward rows, then the reverse rows the
    candidate stage derives from them (offset query prefix, terminate at
    the forward best, per-row phantom bound); sampled rows == the golden
    striped pass."""
    import jax

    from fasim_tpu import rules
    from fasim_tpu.config import GAP_EXTEND, GAP_OPEN
    from fasim_tpu.io import fasta
    from fasim_tpu.kernels import align as kalign
    from fasim_tpu.kernels import gpu
    from fasim_tpu.kernels.xla import XlaScanEngine, window_pass_xla

    _, rna = fasta.read_rna(os.path.join(ORACLE, query))
    m = len(rna)
    q_idx = rules.SSW_ENC[rna]
    eng = XlaScanEngine(rna, device=device)
    eng.setup_windows(rna)
    rng = np.random.default_rng(0)
    W = 256
    segs, lengths = _segments(64, 5120)
    # windows of real DNA, half of them seeded with a stretch of the query
    # so the pass finds real alignments (and reverse rows terminate)
    fwd = np.full((n_rows, W), 4, np.uint8)
    rl = rng.integers(20, 197, n_rows).astype(np.int32)
    long = np.flatnonzero(lengths > W)
    for r in range(n_rows):
        s = int(rng.choice(long))
        lo = int(rng.integers(0, lengths[s] - W))
        fwd[r, :rl[r]] = rules.SSW_ENC[segs[s, lo:lo + rl[r]]]
        if r % 2:
            k = int(rng.integers(0, m - 60))
            fwd[r, 10:min(rl[r], 70)] = q_idx[k:k + min(rl[r], 70) - 10]
    put = lambda a: jax.device_put(a, device)  # noqa: E731
    m16 = (m + 15) // 16 * 16
    f_args = (fwd, np.zeros(n_rows, np.int32), np.full(n_rows, -1, np.int32),
              rl, np.full(n_rows, m16, np.int32))
    tag = f"{query} R={n_rows} W={W}, m={m}"
    out_f = None
    for rev in (False, True):
        if rev:
            best, ecol, erow = out_f[:, 0], out_f[:, 1], out_f[:, 2]
            keep = np.flatnonzero(best > 0)
            codes = np.full((n_rows, W), 4, np.uint8)
            offs = np.zeros(n_rows, np.int32)
            terms = np.full(n_rows, -1, np.int32)
            rlen = np.zeros(n_rows, np.int32)
            mreals = np.full(n_rows, m16, np.int32)
            lanes = np.where(best >= 251, 8, 16)
            for r in keep:
                codes[r, :ecol[r] + 1] = fwd[r, ecol[r]::-1]
                rlen[r] = ecol[r] + 1
                offs[r] = m - 1 - erow[r]
                terms[r] = best[r]
                mreals[r] = m + (-(erow[r] + 1)) % lanes[r]
            args = (codes, offs, terms, rlen, mreals)
        else:
            args = f_args
        dev_args = tuple(put(np.ascontiguousarray(a)) for a in args)
        ref, t_ref = _timed(window_pass_xla, *dev_args, eng.qwin_dev[rev],
                            m=m, rev=rev)
        got, t_ker = _timed(gpu.window_pass_cuda, *dev_args,
                            eng.wprof_dev[rev], m=m, rev=rev)
        ref, got = np.asarray(ref), np.asarray(got)
        name = "window_rev" if rev else "window_fwd"
        if not np.array_equal(ref, got):
            bad = np.flatnonzero((ref != got).any(axis=1))
            raise AssertionError(
                f"{name} [{tag}]: {len(bad)} rows differ, first "
                f"{bad[:3].tolist()}: xla {ref[bad[:3]].tolist()} cuda "
                f"{got[bad[:3]].tolist()}")
        for r in np.flatnonzero(got[:, 0] > 0)[:3]:
            if rev:
                want = kalign._sw_end_pass(
                    q_idx[erow[r]::-1], args[0][r, :args[3][r]].astype(
                        np.int64), GAP_OPEN, GAP_EXTEND, rules.SSW_MAT,
                    16 if best[r] < 251 else 8, False, int(best[r]))
                have = (got[r, 0], got[r, 1], got[r, 2] - args[1][r])
            else:
                want = kalign._sw_end_pass(
                    q_idx, fwd[r, :rl[r]].astype(np.int64), GAP_OPEN,
                    GAP_EXTEND, rules.SSW_MAT, 16, False, None)
                have = tuple(got[r])
            if tuple(int(x) for x in have) != tuple(want[:3]):
                raise AssertionError(f"{name} [{tag}] row {r}: {have} vs "
                                     f"golden {want[:3]}")
        print(f"{name} [{tag}]: exact vs window_pass_xla and 3 golden rows "
              f"({int((got[:, 0] > 0).sum())} rows aligned; first calls: "
              f"xla {t_ref:.3f} s, cuda {t_ker:.3f} s)", flush=True)
        if timing:
            _memory(f"{name} xla [{tag}]", window_pass_xla, *dev_args,
                    eng.qwin_dev[rev], m=m, rev=rev)
            _memory(f"{name} cuda [{tag}]", gpu.window_pass_cuda, *dev_args,
                    eng.wprof_dev[rev], m=m, rev=rev)
            _turns(name, window_pass_xla, gpu.window_pass_cuda,
                   (dev_args + (eng.qwin_dev[rev],),
                    dev_args + (eng.wprof_dev[rev],)),
                   {"m": m, "rev": rev}, {"m": m, "rev": rev}, tag)
        out_f = got


def run_case(case: str, f1: str, f2: str, extra: list[str],
             argv_extra: list[str] = ()) -> float:
    """One CLI run in this process; every output file must equal the
    golden byte for byte.  Returns the wall seconds."""
    from fasim_tpu import cli

    golden = os.path.join(ORACLE, "golden", case)
    out = tempfile.mkdtemp(prefix=f"smoke_{case}_")
    prev = os.getcwd()
    os.chdir(ORACLE)  # output names embed the -f1 path
    t = time.perf_counter()
    try:
        rc = cli.main(["-f1", f1, "-f2", f2, "-O", out + "/", *extra,
                       *argv_extra])
    finally:
        os.chdir(prev)
        os.environ.pop("FASIM_SIM_DEVICE", None)
    dt = time.perf_counter() - t
    if rc != 0:
        raise AssertionError(f"{case}: cli.main returned {rc}")
    want = sorted(f for f in os.listdir(golden) if not f.startswith("stdout"))
    have = sorted(os.listdir(out))
    if have != want:
        raise AssertionError(f"{case}: outputs {have} != golden {want}")
    for f in want:
        if not filecmp.cmp(os.path.join(out, f), os.path.join(golden, f),
                           shallow=False):
            raise AssertionError(f"{case}: {f} differs from the golden")
    return dt


def phase0(n_cards: int):
    import jax
    import jaxlib

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: needs an NVIDIA GPU; JAX found "
                         f"{devs[0].platform!r} devices")
    if len(devs) < n_cards:
        raise SystemExit(f"chip_smoke: needs {n_cards} GPUs, found "
                         f"{len(devs)}")
    from fasim_tpu import native, runtime
    from fasim_tpu.kernels import gpu

    print(f"device: {devs[0].device_kind} x{len(devs)}", flush=True)
    print(f"card: {card()}", flush=True)
    print(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}", flush=True)
    print(f"compile cache: {runtime.enable_compile_cache()}", flush=True)
    nvcc = subprocess.run([gpu.nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"nvcc: {nvcc.splitlines()[-1]}", flush=True)
    t = time.perf_counter()
    native._load()
    gpu.register()
    print(f"set-up: native + CUDA libraries built and loaded in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    with open(gpu.PTXAS_LOG) as f:
        log = f.read()
    regs = re.findall(r"Used (\d+) registers", log)
    spills = sorted(set(re.findall(r"(\d+) bytes spill stores", log)))
    print(f"ptxas: registers per kernel instance {' '.join(regs)}; spill "
          f"store bytes {' '.join(spills)}", flush=True)
    return devs


def four_cards(devs, dna: str = "meg3dna.fa", case: str = "meg3_full",
               batch_pairs: int = 64) -> None:
    """MEG3-full on 4 cards through the CLI's round-robin engines and the
    in-process distributed runner; both byte-identical to the golden, and
    every card must have run batches."""
    from fasim_tpu.cli import make_engine
    from fasim_tpu.config import Params, TpuConfig
    from fasim_tpu.dist.runner import scan_distributed
    from fasim_tpu.post.output import print_result
    from fasim_tpu.scan.batched import scan_file_batched

    cfg = TpuConfig()
    golden = os.path.join(ORACLE, "golden", case)
    routes = {
        "round-robin": lambda p, engines: scan_file_batched(
            p, engines, batch_pairs=batch_pairs,
            max_inflight=cfg.max_inflight),
        "distributed": lambda p, engines: scan_distributed(
            p, lambda rna: engines, batch_pairs=batch_pairs,
            max_inflight=cfg.max_inflight),
    }
    from fasim_tpu.io import fasta

    _, rna = fasta.read_rna(os.path.join(ORACLE, "MEG3.fa"))
    prev = os.getcwd()
    os.chdir(ORACLE)
    try:
        for name, route in routes.items():
            engines = make_engine(cfg, rna)
            out = tempfile.mkdtemp(prefix=f"smoke4_{name}_")
            p = Params(file1path=dna, file2path="MEG3.fa",
                       outpath=out + "/")
            t = time.perf_counter()
            recs, lnc, _, hits = route(p, engines)
            r0 = recs[0]
            seq_len = getattr(r0, "seq_len", None) or len(r0.seq)
            print_result(p, r0.species, lnc, hits, r0.chro_tag, seq_len,
                         r0.start_genome)
            dt = time.perf_counter() - t
            for f in sorted(f for f in os.listdir(golden)
                            if not f.startswith("stdout")):
                if not filecmp.cmp(os.path.join(out, f),
                                   os.path.join(golden, f), shallow=False):
                    raise AssertionError(f"4 cards {name}: {f} differs")
            counts = [e.n_batches for e in engines]
            print(f"4 cards {name}: {case} byte-identical in {dt:.3f} s "
                  f"on {card()}; batches per card {counts}", flush=True)
            if len(engines) != 4 or min(counts) == 0:
                raise AssertionError(f"4 cards {name}: batches per card "
                                     f"{counts}")
    finally:
        os.chdir(prev)
    for d in devs:
        print(f"peak_bytes_in_use {d}: "
              f"{d.memory_stats()['peak_bytes_in_use']}", flush=True)


def main(argv: list[str]) -> int:
    n_cards = 4 if "--four-cards" in argv else 1
    devs = phase0(n_cards)
    if n_cards == 4:
        four_cards(devs[:4])
    else:
        dev = devs[0]
        t = time.perf_counter()
        check_colmax(dev, "MEG3.fa", timing=True)
        check_colmax(dev, "NEAT1.fa", n_segs=8, timing=True)
        check_window(dev, "MEG3.fa", timing=True)
        check_window(dev, "NEAT1.fa", n_rows=1024, timing=True)
        print(f"phase 1: kernel parity in {time.perf_counter() - t:.1f} s",
              flush=True)
        name = card()
        for case, f1, f2, extra in E2E_CASES:
            dt = run_case(case, f1, f2, extra)
            print(f"e2e {case}: byte-identical in {dt:.3f} s on {name}",
                  flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
