"""-F (SIM exact engine) throughput micro-benchmark.

Times the native SIM engine (forward scan + extraction) on one
(segment, transform) pair at a realistic shape and reports cell rate;
also times a small all-transforms segment scan.  Host-only (no device).

    python scripts/bench_sim.py [--m=1582] [--n=5128] [--round=4]
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np

from fasim_tpu import native, rules
from fasim_tpu.io import fasta


def main() -> int:
    m = int(next((a.split("=")[1] for a in sys.argv
                  if a.startswith("--m=")), "1582"))
    n = int(next((a.split("=")[1] for a in sys.argv
                  if a.startswith("--n=")), "5128"))
    _, rna_full = fasta.read_rna(os.path.join(REPO, "oracle/MEG3.fa"))
    rna = rna_full[:m]
    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", np.uint8)
    seg = bases[rng.integers(0, 4, n)]
    # plant homologies so extraction does real work
    for _ in range(6):
        lo = int(rng.integers(0, n - 400))
        ql = int(rng.integers(60, 300))
        qs = int(rng.integers(0, m - ql))
        piece = rna[qs:qs + ql].copy()
        muts = rng.random(ql) < 0.1
        piece[muts] = bases[rng.integers(0, 4, int(muts.sum()))]
        seg[lo:lo + ql] = piece
    scan = rules.scan_list(0, 0)[0]
    s2, src = rules.make_scan_strings(seg, scan)
    min_score = 60
    t0 = time.time()
    reps = 3
    nrows = 0
    for _ in range(reps):
        rows = native.sim_scan(rna.tobytes(), s2.tobytes(), src.tobytes(),
                               0, min_score, scan["strand"], scan["para"],
                               10, 1000, 1, 0)
        nrows = len(rows)
    dt = (time.time() - t0) / reps
    gcups = m * n / dt / 1e9
    # device path: forward scan on device + host node-list replay
    from fasim_tpu.kernels.sim_dev import sim_forward_cells

    cells = sim_forward_cells(rna, [s2], [min_score])  # compile
    t0 = time.time()
    for _ in range(reps):
        cells = sim_forward_cells(rna, [s2], [min_score])
        rows_d = native.sim_scan_replay(
            rna.tobytes(), s2.tobytes(), src.tobytes(), 0, min_score,
            scan["strand"], scan["para"], 10, 1000, 1, 0, cells[0])
    dt_dev = (time.time() - t0) / reps
    assert rows_d == rows, "device SIM path diverged from host"
    rnd = next((a.split("=")[1] for a in sys.argv
                if a.startswith("--round=")), None)
    out = {"m": m, "n": n, "pair_seconds": round(dt, 3),
           "sim_gcups": round(gcups, 4), "rows": nrows,
           "device_pair_seconds": round(dt_dev, 3),
           "device_sim_gcups": round(m * n / dt_dev / 1e9, 4),
           "device_identical": True}
    print(json.dumps(out))
    if rnd:
        with open(os.path.join(REPO, f"SIMBENCH_r{rnd}.json"), "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
