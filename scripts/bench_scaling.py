"""Host-scaling benchmark: 1/2/4-process jax.distributed loopback on CPU.

BASELINE.json's north star asks for >= 80% linear scaling across hosts.
This measures the framework's *own* overhead curve — shard + scan +
allgather + merge — on the CPU backend, where the workload is compute-
bound and any coordination overhead shows up directly as lost efficiency.
Writes SCALING_r<N>.json at the repo root:

    python scripts/bench_scaling.py [--round=2] [--procs=1,2,4]

Each process scans a round-robin shard of the MEG3 multi-record input
(oracle/meg3sub3.fa x MEG3.fa by default; pass --full for the 532-record
file) and process 0 writes the output files, which are byte-compared to
the committed goldens — scaling must never change results.
"""

import filecmp
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE = os.path.join(REPO, "oracle")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_loopback(nproc: int, dna: str, rna: str, workdir: str,
                 golden_case: str = "meg3_sub3") -> float:
    """Returns the WARM (second-rep, compile-amortized) scan seconds of
    process 0; each worker is pinned to one host thread so speedup
    measures the framework's shard/gather/merge overhead, not incidental
    intra-process threading."""
    port = _free_port()
    out = os.path.join(workdir, f"out{nproc}")
    os.makedirs(out, exist_ok=True)
    procs = []
    for pid in range(nproc):
        env = dict(os.environ)
        env.update({
            "JAX_PLATFORMS": "cpu",
            "PYTHONPATH": REPO,
            "FASIM_COORD": f"127.0.0.1:{port}",
            "FASIM_NPROC": str(nproc),
            "FASIM_PID": str(pid),
            "FASIM_HOST_THREADS": "1",
            "FASIM_SCALING_REPS": "2",
            "FASIM_CPU_PIN": "1",
        })
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "fasim_tpu.dist.runner",
             "-f1", dna, "-f2", rna, "-O", f"out{nproc}/"],
            cwd=workdir, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    outs = [pr.communicate(timeout=3600)[0] for pr in procs]
    for pr, text in zip(procs, outs):
        if pr.returncode != 0:
            raise RuntimeError(text.decode()[-2000:])
    stats = {"wall_s": None, "local_s": [], "gather_s": []}
    for text in outs:
        for line in text.decode().splitlines():
            if line.startswith("FASIM_SCAN_SECONDS rep=1"):
                kv = dict(t.split("=") for t in line.split()[1:])
                if kv["pid"] == "0":
                    stats["wall_s"] = round(float(kv["total"]), 2)
                stats["local_s"].append(round(float(kv["local"]), 2))
                stats["gather_s"].append(round(float(kv["gather"]), 2))
    if stats["wall_s"] is None:
        raise RuntimeError("no warm-rep timing line from process 0")
    golden = os.path.join(ORACLE, "golden", golden_case)
    for name in os.listdir(golden):
        if name.startswith("stdout"):
            continue
        if not filecmp.cmp(os.path.join(out, name),
                           os.path.join(golden, name), shallow=False):
            raise RuntimeError(f"{nproc}-proc output differs: {name}")
    return stats


def main() -> int:
    rnd = next((a.split("=")[1] for a in sys.argv
                if a.startswith("--round=")), "NN")
    procs = [int(x) for x in next(
        (a.split("=")[1] for a in sys.argv if a.startswith("--procs=")),
        "1,2,4").split(",")]
    # default: 16-record subset — enough work items to shard 1/2/4 ways
    # evenly (the old 3-record default could not split 2 ways without
    # 2:1 imbalance, which alone caps efficiency at 75%) while a pinned
    # single XLA-CPU core still finishes a rep in ~2 min on this box.
    # --sub64 / --full: the 64-record / 532-record inputs.
    full = "--full" in sys.argv
    if full:
        dna, case = "meg3dna.fa", "meg3_full"
    elif "--sub64" in sys.argv:
        dna, case = "meg3sub64.fa", "meg3_sub64"
    else:
        dna, case = "meg3sub16.fa", "meg3_sub16"
    results = {"input": dna}
    with tempfile.TemporaryDirectory() as td:
        shutil.copy(os.path.join(ORACLE, dna), td)
        shutil.copy(os.path.join(ORACLE, "MEG3.fa"), td)
        for n in procs:
            try:
                stats = run_loopback(n, dna, "MEG3.fa", td, case)
            except Exception as e:  # record, keep measuring other widths
                results[str(n)] = {"error": str(e)[-300:]}
                print(f"{n} proc: FAILED ({e})")
                continue
            results[str(n)] = stats
            print(f"{n} proc: {stats['wall_s']}s locals={stats['local_s']}"
                  f" gathers={stats['gather_s']}")
    base = results[str(procs[0])].get("wall_s")
    ncpu = os.cpu_count() or 1
    for n in procs:
        if base is None or "wall_s" not in results[str(n)]:
            continue
        # ideal speedup is capped by physical cores: oversubscribed
        # widths are judged against the core-bound ideal
        ideal = base * min(procs[0], ncpu) / min(n, ncpu)
        eff = ideal / results[str(n)]["wall_s"]
        results[str(n)]["efficiency"] = round(eff, 3)
        print(f"{n} proc efficiency: {eff:.1%}")
    # note: this box has 2 CPUs; 4-proc efficiency is bounded by
    # oversubscription, not by the framework — record the CPU count
    results["ncpu"] = os.cpu_count()
    results["note"] = ("CPU loopback overhead curve; outputs byte-compared"
                       " to goldens at every width")
    path = os.path.join(REPO, f"SCALING_r{rnd}.json")
    with open(path, "w") as f:
        json.dump(results, f, indent=1)
    print("->", path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
