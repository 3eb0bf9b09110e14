"""Host-stage microprofile: peaks extraction + finalize (banded/convert/
dedup) on real MEG3 segments, CPU-only (XLA engine generates the real
candidate stream).  Attributes the host wall of the e2e run.

    JAX_PLATFORMS=cpu python scripts/profile_host.py
"""

import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np

from fasim_tpu import native, rules
from fasim_tpu.config import GAP_EXTEND, GAP_OPEN, Params
from fasim_tpu.io import fasta
from fasim_tpu.kernels.common import pack_candidates_np
from fasim_tpu.kernels.xla import XlaScanEngine
from fasim_tpu.scan import candidates as C
from fasim_tpu.scan.batched import _ScanMeta, enumerate_work

os.chdir(os.path.join(REPO, "oracle"))
p = Params(file1path="meg3dna.fa", file2path="MEG3.fa", outpath="/tmp")
records = fasta.read_dna(p.file1path)
_, rna = fasta.read_rna(p.file2path)
work, scans = enumerate_work(p, records)
eng = XlaScanEngine(rna)
eng.setup_scans(scans)
eng.setup_windows(rna)
meta = _ScanMeta(scans)
q_idx = np.ascontiguousarray(rules.SSW_ENC[rna], np.int32)
rna_b = rna.tobytes()

NSEG = int(os.environ.get("NSEG", "6"))
batch = work[:NSEG]
n_pad = (max(len(w.segment) for w in batch) + 127) // 128 * 128
segs = np.zeros((NSEG, n_pad), np.uint8)
lengths = np.zeros(NSEG, np.int32)
for i, w in enumerate(batch):
    segs[i, :len(w.segment)] = w.segment
    lengths[i] = len(w.segment)

print("scanning (XLA cpu)...")
gm, cm = eng.scan_segments(segs, lengths)
gm = np.asarray(gm)
cm = np.asarray(cm)
pos, val, cnt = pack_candidates_np(gm, cm, lengths, 384)

# --- peaks stage timing (as the driver runs it)
t0 = time.time()
reps = 20
for _ in range(reps):
    pks = []
    for i, w in enumerate(batch):
        pk = native.segment_peaks_packed(pos[i], val[i], cnt[i])
        pks.append(pk)
dt_peaks = (time.time() - t0) / reps
npeaks = sum(len(x) for x in pks)
print(f"peaks: {npeaks} peaks, {dt_peaks*1e3:.1f} ms per {NSEG}-seg batch "
      f"({dt_peaks/NSEG*1e3:.2f} ms/segment)")

# --- build the real winner stream via the full candidate stage decision
# (reuse candidate_stage_batch's pure logic by calling the XLA windows)
from concurrent.futures import ThreadPoolExecutor

from fasim_tpu.profiling import STAGES

pool = ThreadPoolExecutor(2)
t0 = time.time()
outs = C.candidate_stage_batch(
    p, rna, q_idx, rna_b, meta, batch, segs, lengths, gm,
    lambda sel: cm[sel], (pos, val, cnt), eng, pool)
res = [f.result() for _, f in outs]
dt_stage = time.time() - t0
nhits = sum(len(r) for r in res)
print(f"candidate stage (incl. XLA windows): {dt_stage:.1f}s, "
      f"{nhits} triplexes")
print({k: round(v, 3) for k, v in STAGES.report().items()})
