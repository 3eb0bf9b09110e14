"""MEG3-full end to end on the GPU: the CUDA kernels against plain XLA.

    python bench.py [--runs=xla/xla,cuda/cuda,cuda/cuda,xla/xla]

Scans oracle/meg3dna.fa (1.32 Mb in 532 records) against MEG3.fa
(1,582 nt) with the upstream defaults (-c 5000 -o 100) through the
batched driver and the device engines (kernels/xla.py), byte-compares
every output file with oracle/golden/meg3_full, and prints one JSON
line.  Each entry of --runs is one timed run, "<scan>/<window>": the
implementation of the scan pass and of the window pass, the CUDA kernels
("cuda") or the plain XLA programs ("xla"); one untimed run of each
entry first pays its compiles.  Give the order in turns (A, B, B, A) so
drift on the card shows.

Needs an NVIDIA GPU: the device (platform, kind, count) and the card's
name and power limit are printed with the result, and without a GPU the
script exits before any work.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)


def card() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def run_meg3(engines, impl: str, dna: str = "meg3dna.fa",
             case: str = "meg3_full") -> tuple[float, dict]:
    """One MEG3-full run with every engine on `impl` ("<scan>/<window>");
    returns (wall seconds, stage split) after checking the outputs."""
    from fasim_tpu.config import Params, TpuConfig
    from fasim_tpu.post.output import print_result
    from fasim_tpu.profiling import STAGES
    from fasim_tpu.scan.batched import scan_file_batched

    for e in engines:
        e.scan_impl, e.window_impl = impl.split("/")
    cfg = TpuConfig()
    golden = os.path.join(REPO, "oracle", "golden", case)
    with tempfile.TemporaryDirectory() as out:
        p = Params(file1path=dna, file2path="MEG3.fa",
                   outpath=out + "/")
        STAGES.start_run()
        t = time.perf_counter()
        recs, lnc, _, hits = scan_file_batched(
            p, engines, batch_pairs=cfg.segments_per_batch,
            max_inflight=cfg.max_inflight)
        r0 = recs[0]
        print_result(p, r0.species, lnc, hits, r0.chro_tag, len(r0.seq),
                     r0.start_genome)
        dt = time.perf_counter() - t
        stages = STAGES.report()
        for f in sorted(os.listdir(golden)):
            if f.startswith("stdout"):
                continue
            with open(os.path.join(out, f), "rb") as a, \
                    open(os.path.join(golden, f), "rb") as b:
                if a.read() != b.read():
                    raise AssertionError(f"{impl}: {f} differs from golden")
    return dt, stages


def main(argv: list[str]) -> int:
    import jax

    runs = next((a.split("=", 1)[1].split(",") for a in argv
                 if a.startswith("--runs=")),
                ["xla/xla", "cuda/cuda", "cuda/cuda", "xla/xla"])
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench: needs an NVIDIA GPU; JAX found "
                         f"{devs[0].platform!r} devices")
    from fasim_tpu.cli import make_engine
    from fasim_tpu.config import TpuConfig
    from fasim_tpu.io import fasta

    os.chdir(os.path.join(REPO, "oracle"))  # output names embed -f1
    _, rna = fasta.read_rna("MEG3.fa")
    engines = make_engine(TpuConfig(dp_devices=1), rna)
    cold = {impl: run_meg3(engines, impl)[0] for impl in dict.fromkeys(runs)}
    walls: dict[str, list[float]] = {impl: [] for impl in cold}
    stages = {}
    for impl in runs:
        dt, stages[impl] = run_meg3(engines, impl)
        walls[impl].append(dt)
        print(f"meg3_full {impl}: {dt:.3f} s", flush=True)
    print(json.dumps({
        "case": "meg3_full", "output_identical": True,
        "wall_s": walls, "first_run_s": cold, "stages_last_run": stages,
        "device": {"platform": devs[0].platform,
                   "kind": devs[0].device_kind, "count": len(devs)},
        "card": card()}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
