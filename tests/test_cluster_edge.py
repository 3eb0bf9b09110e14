"""cluster_triplex near-RNA-start regime (reference UB: size_t key wrap).

The reference hangs (its re-scan loop never passes a wrapped negative
key, Fasim-LongTarget.cpp:680-688), so there is no binary output to
byte-match; the framework must instead warn and produce the deterministic
sane-loop-bound output."""

import warnings

import numpy as np

from fasim_tpu.post.output import cluster_triplex
from fasim_tpu.scan.pipeline import Triplex


def _t(stari, endi, starj=100, endj=160, nt=60):
    return Triplex(stari=stari, endi=endi, starj=starj, endj=endj,
                   strand=0, reverse=1, rule=1, nt=nt,
                   score=np.float32(100), identity=np.float32(90),
                   tri_score=np.float32(2.5), stri_align="A" * nt,
                   strj_align="T" * nt)


def test_cluster_midpoint_near_rna_start_warns_not_raises():
    # middle = (1 + 9) // 2 = 5 < dd=15 -> negative density keys
    tlist = [_t(1, 9), _t(1, 11), _t(400, 460)]
    class1 = [dict() for _ in range(6)]
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        cluster_triplex(15, 50, tlist, class1, 5)
    assert any("size_t key wrap" in str(w.message) for w in rec)
    # deterministic classes; every triplex captured by some density peak
    motifs = [t.motif for t in tlist]
    assert all(m > 0 for m in motifs)
    tlist2 = [_t(1, 9), _t(1, 11), _t(400, 460)]
    class2 = [dict() for _ in range(6)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cluster_triplex(15, 50, tlist2, class2, 5)
    assert [t.motif for t in tlist2] == motifs
    assert class2 == class1
