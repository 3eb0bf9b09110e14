"""fasim-compatible command-line interface.

Accepts the reference's flag surface (initEnv, Fasim-LongTarget.cpp:269-377):
-f1 -f2 -O -r -c -m -t -d -i -S -ni -na -pc -pt -o -F -ds -lg -C (long form
with single dash, getopt_long_only style) plus the short aliases from its
optstring.  Numeric flags use atoi semantics (leading integer, 0 on garbage).

Framework-native flags are prefixed with --tpu- (a historical prefix;
they configure the device path) and do not collide.
"""

from __future__ import annotations

import os
import sys

from .config import Params, TpuConfig
from .runtime import enable_compile_cache, require_device_platform


def _atoi(s: str) -> int:
    """C atoi: optional sign + leading digits, 0 otherwise."""
    s = s.strip()
    i = 0
    if i < len(s) and s[i] in "+-":
        i += 1
    j = i
    while j < len(s) and s[j].isdigit():
        j += 1
    if j == i:
        return 0
    return int(s[:j])


_VALUE_FLAGS = {
    "f1": ("file1path", str), "f": ("file1path", str),
    "f2": ("file2path", str), "s": ("file2path", str),
    "O": ("outpath", str),
    "r": ("rule", _atoi),
    "c": ("cut_length", _atoi),
    "m": ("min_score", _atoi),
    "t": ("strand", _atoi),
    "i": ("min_identity", _atoi),       # atoi despite float field (:340)
    "S": ("min_stability", _atoi),      # atoi despite float field (:343)
    "ni": ("nt_min", _atoi), "y": ("nt_min", _atoi),
    "na": ("nt_max", _atoi), "z": ("nt_max", _atoi),
    "pc": ("penalty_c", _atoi), "Y": ("penalty_c", _atoi),
    "pt": ("penalty_t", _atoi), "Z": ("penalty_t", _atoi),
    "o": ("overlap_length", _atoi),
    "ds": ("c_distance", _atoi), "D": ("c_distance", _atoi),
    "lg": ("c_length", _atoi), "E": ("c_length", _atoi),
    "cn": ("corenum", _atoi), "C": ("corenum", _atoi),
}


def parse_args(argv: list[str]) -> tuple[Params, TpuConfig]:
    p = Params()
    cfg = TpuConfig()
    i = 0
    if not argv:
        show_help()
    while i < len(argv):
        a = argv[i]
        if not a.startswith("-"):
            i += 1
            continue
        name = a.lstrip("-")
        if name == "h" or name == "help":
            show_help()
        elif name == "d":
            p.detail_output = True
            i += 1
        elif name == "F":
            p.do_fast_sim = False
            i += 1
        elif name.startswith("tpu-"):
            key = name[4:].replace("-", "_")
            if not hasattr(cfg, key):
                sys.exit(f"unknown flag --{name}")
            cur = getattr(cfg, key)
            val = argv[i + 1]
            setattr(cfg, key, type(cur)(val) if not isinstance(cur, bool)
                    else val.lower() in ("1", "true", "yes"))
            i += 2
        elif name in _VALUE_FLAGS:
            field, conv = _VALUE_FLAGS[name]
            if i + 1 >= len(argv):
                sys.exit(f"flag -{name} requires a value")
            setattr(p, field, conv(argv[i + 1]))
            i += 2
        else:
            sys.exit(f"unknown flag {a}")
    return p, cfg


def show_help() -> None:
    print("fasim_tpu — JAX triplex scanner for NVIDIA GPUs (Fasim-LongTarget "
          "compatible)\n"
          "usage: python -m fasim_tpu.cli -f1 DNA.fa -f2 RNA.fa -O outdir "
          "[-r N] [-c 5000] [-t 0] [-o 100]\n"
          "       [-i 60] [-S 1] [-ni 20] [-na 100000] [-pc 0] [-pt -1000] "
          "[-ds 15] [-lg 50] [-F] [-C N]\n"
          "device flags: --tpu-engine auto|xla|numpy  --tpu-dp-devices N")
    sys.exit(1)


def make_engine(cfg: TpuConfig, rna):
    """Resolve the TpuConfig.engine choice to a scan engine per local
    device (or None for the per-segment NumPy golden path).

    Returns a list of engines — one per device used — for the batched
    driver's round-robin dispatch (dp_devices=0 uses every local device;
    single-card hosts get a one-element list).
    """
    which = cfg.engine
    if which == "numpy":
        return None
    if which not in ("auto", "xla"):
        sys.exit(f"unknown engine {which!r} (auto|xla|numpy)")
    enable_compile_cache()
    require_device_platform()
    import jax

    from .kernels.xla import XlaScanEngine

    devices = jax.local_devices()
    if cfg.dp_devices > 0:
        devices = devices[:cfg.dp_devices]
    return [XlaScanEngine(rna, device=d) for d in devices]


def main(argv: list[str] | None = None) -> int:
    from .io import fasta
    from .post.output import print_result
    from .scan.batched import scan_file_batched, scan_file_stream
    from .scan.pipeline import scan_file

    p, cfg = parse_args(sys.argv[1:] if argv is None else argv)
    if cfg.sim_device:
        os.environ["FASIM_SIM_DEVICE"] = "1"
    engine_name = "Fasim" if p.do_fast_sim else "Sim"
    print(f"Searching triplexes using {engine_name}")
    profile = cfg.profile or os.environ.get("FASIM_PROFILE", "") not in ("",
                                                                         "0")
    if profile:
        from .profiling import STAGES

        STAGES.start_run()
    import time as _time

    t_start = _time.process_time()
    _, rna_probe = fasta.read_rna(p.file2path)
    engine = make_engine(cfg, rna_probe)
    if cfg.stdout_compat:
        # the reference interleaves these with the scan; the final stream
        # is identical when printed up front (record/segment order)
        lnc_probe, _ = fasta.read_rna(p.file2path)
        print(lnc_probe)
        # iter_dna keeps memory O(current record) even in stream mode
        for rec in fasta.iter_dna(p.file1path):
            _, starts = fasta.cut_sequence(rec.seq, p.cut_length,
                                           p.overlap_length)
            for s in starts:
                print(f"dnaPos = {s}")
    if engine is None:
        records, lnc_name, rna, tlist = scan_file(p)
    else:
        stream = (cfg.stream == "on"
                  or (cfg.stream == "auto"
                      and os.path.getsize(p.file1path) > 32 * 1024 * 1024))
        runner = scan_file_stream if stream else scan_file_batched
        records, lnc_name, rna, tlist = runner(
            p, engine, batch_pairs=cfg.segments_per_batch,
            max_inflight=cfg.max_inflight)
    first = records[0]
    dna_size = getattr(first, "seq_len", None)
    if dna_size is None:
        dna_size = len(first.seq)
    print_result(p, first.species, lnc_name, tlist, first.chro_tag,
                 dna_size, first.start_genome,
                 stdout_compat=cfg.stdout_compat)
    print("finished normally")
    if cfg.stdout_compat:
        # reference: clock()-based CPU seconds (never byte-compared)
        print(f"Running time is {_time.process_time() - t_start:.6g}")
    if profile:
        import json

        from .profiling import STAGES

        print("FASIM_PROFILE " + json.dumps(STAGES.report()),
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
