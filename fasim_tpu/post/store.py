"""Columnar triplex hit store for genome-scale streaming runs.

The reference holds every hit as an in-memory struct until the global
clustering/output pass (Fasim-LongTarget.cpp:156-166, clustering is
global over the RNA axis so it cannot start earlier, :812).  At genome
scale (~1.5k hits/Mb measured -> ~4.5M hits for 3.1 Gb) a list of
Python Triplex objects plus their alignment strings costs gigabytes;
this store keeps the numeric columns as flat numpy arrays (~60 B/hit)
and spills the two alignment strings to an append-only temp file that
is mmap-read back only at TFOsorted-write time — peak RAM for hits is
O(numeric columns), independent of alignment-string volume.

Semantics are pinned to post/output.py's object implementation
(cluster_triplex / write_tfosorted quirk catalogue); outputs are
byte-identical (tests/test_batched_driver.py runs both paths on the same
input).
"""

from __future__ import annotations

import mmap
import os
import tempfile

import numpy as np

from .. import native
from ..config import Params
from .output import _fmt_f, get_strand, write_cluster


_I32 = ("stari", "endi", "starj", "endj", "strand", "reverse", "rule",
        "nt", "genomestart", "genomeend")
_F32 = ("score", "identity", "tri_score")


class TriplexStore:
    """Append-per-record columnar hit store with optional string spill.

    Records append via `add_record` (a record's filtered hits, already
    coordinate-fixed) with the `-C` bucket id; `finalize()` reorders
    rows into the reference's bucket-concatenation order
    (Fasim-LongTarget.cpp:156-163) and freezes the columns.
    """

    def __init__(self, spill_dir: str | None = None):
        self._parts: list[dict] = []
        self._strs: list[tuple] = []  # RAM strings when not spilling
        self._spill = None
        if spill_dir is not None:
            os.makedirs(spill_dir, exist_ok=True)
            fd, self._spill_path = tempfile.mkstemp(
                prefix="fasim-strspill-", dir=spill_dir)
            self._spill = os.fdopen(fd, "wb+")
        self._soff: list[np.ndarray] = []  # (n, 3) int64 off/len1/len2
        self._chr: list[str] = []  # per part (one record each)
        self._off = 0
        self.n = 0
        self.cols: dict[str, np.ndarray] = {}

    def __len__(self) -> int:
        return self.n

    def add_record(self, bucket: int, chro: str, hits: list) -> None:
        """Append one record's hits (list of Triplex-like objects)."""
        n = len(hits)
        if n == 0:
            return
        part = {f: np.fromiter((getattr(t, f) for t in hits), np.int32,
                               n) for f in _I32}
        for f in _F32:
            part[f] = np.fromiter((getattr(t, f) for t in hits),
                                  np.float32, n)
        part["bucket"] = np.full(n, bucket, np.int32)
        off = np.empty((n, 3), np.int64)
        if self._spill is not None:
            for i, t in enumerate(hits):
                a = t.stri_align.encode("latin-1")
                b = t.strj_align.encode("latin-1")
                off[i] = (self._off, len(a), len(b))
                self._spill.write(a)
                self._spill.write(b)
                self._off += len(a) + len(b)
        else:
            for i, t in enumerate(hits):
                off[i, 0] = len(self._strs)
                self._strs.append((t.stri_align, t.strj_align))
        self._soff.append(off)
        self._chr.append(chro)
        self._parts.append(part)
        self.n += n

    def finalize(self) -> "TriplexStore":
        """Freeze columns in bucket-concatenation order."""
        if not self._parts:
            for f in _I32:
                self.cols[f] = np.empty(0, np.int32)
            for f in _F32:
                self.cols[f] = np.empty(0, np.float32)
            self.cols["bucket"] = np.empty(0, np.int32)
            self._order_soff = np.empty((0, 3), np.int64)
            self._order_chr = np.empty(0, np.int32)
            self._chr_tab = []
            return self
        cat = {k: np.concatenate([p[k] for p in self._parts])
               for k in self._parts[0]}
        soff = np.concatenate(self._soff)
        chri = np.concatenate([np.full(len(o), i, np.int32)
                               for i, o in enumerate(self._soff)])
        # stable sort by bucket == concatenating the buckets in order,
        # each keeping its record-order appends
        order = np.argsort(cat["bucket"], kind="stable")
        self.cols = {k: v[order] for k, v in cat.items()}
        self._order_soff = soff[order]
        self._order_chr = chri[order]
        self._chr_tab = self._chr
        self._parts.clear()
        self._soff.clear()
        if self._spill is not None:
            self._spill.flush()
        return self

    # clustering state (filled by cluster_store)
    def alloc_cluster_cols(self) -> None:
        for f in ("middle", "center", "motif", "neartriplex"):
            self.cols[f] = np.zeros(self.n, np.int32)

    def strings(self, i: int) -> tuple[str, str]:
        off, l1, l2 = self._order_soff[i]
        if self._spill is None:
            return self._strs[off]
        a = self._mm[off:off + l1].decode("latin-1")
        b = self._mm[off + l1:off + l1 + l2].decode("latin-1")
        return a, b

    def chro(self, i: int) -> str:
        return self._chr_tab[self._order_chr[i]]

    def open_strings(self):
        if self._spill is not None and self._off:
            self._mm = mmap.mmap(self._spill.fileno(), 0,
                                 access=mmap.ACCESS_READ)

    def close(self) -> None:
        if self._spill is not None:
            if getattr(self, "_mm", None) is not None:
                self._mm.close()
            self._spill.close()
            os.unlink(self._spill_path)
            self._spill = None


def cluster_store(dd: int, length: int, st: TriplexStore,
                  class1: list[dict], class_level: int = 5) -> None:
    """Array port of output.cluster_triplex (Fasim-LongTarget.cpp:600-
    691) — identical final state: the sequential density accumulation
    (first-max-wins tracking), the per-class capture of motif==0 hits
    with middle in [max_pos-dd, max_pos+dd], the zombie map entries of
    the re-scan, and the negative-key documented-UB handling."""
    st.alloc_cluster_cols()
    near: dict[int, int] = {}
    max_near = 0
    max_pos = 0
    find = 0
    warned = False
    elig = st.cols["nt"] > length
    middle = (st.cols["stari"] + st.cols["endi"]) // 2
    st.cols["middle"][elig] = middle[elig]
    motif = st.cols["motif"]
    for ti in np.flatnonzero(elig):
        mid = int(middle[ti])
        near.setdefault(mid, 0)
        if mid - dd < 0 and not warned:
            import warnings

            warnings.warn(
                "cluster midpoint within c_distance of the RNA start: "
                "reference behavior is a hang (size_t key wrap); "
                "emitting sane-loop-bound output instead")
            warned = True
        for i in range(-dd, dd + 1):
            pos = mid + i
            if i > 0:
                near[pos] = near.get(pos, 0) + (dd - i)
            elif i < 0:
                near[pos] = near.get(pos, 0) + (dd + i)
            else:
                near.setdefault(pos, 0)
            if near.get(pos, 0) > max_near:
                max_near = near[pos]
                max_pos = pos
                find = 1
        st.cols["neartriplex"][ti] = near[mid]
    theclass = 1
    starj = st.cols["starj"]
    endj = st.cols["endj"]
    while find:
        # NOTE no eligibility mask here: ineligible hits keep middle 0
        # and ARE captured when the class range covers position 0 —
        # exactly the object implementation's `t.middle == i` check
        # over all hits (and the reference's, Fasim-LongTarget.cpp:
        # 652-672 with struct-default middle)
        sel = np.flatnonzero((motif == 0) & (st.cols["middle"] >=
                                             max_pos - dd)
                             & (st.cols["middle"] <= max_pos + dd))
        motif[sel] = theclass
        st.cols["center"][sel] = max_pos
        if theclass <= class_level:
            cmap = class1[theclass]
            for ti in sel:
                a, b = int(starj[ti]), int(endj[ti])
                lo, hi = (a, b) if b > a else (b, a)
                for j in range(lo, hi):
                    cmap[j] = cmap.get(j, 0) + 1
        for i in range(max_pos - dd, max_pos + dd + 1):
            near.pop(i, None)
        max_near = 0
        find = 0
        if near:
            max_key = max(near)
            for i in range(0, max_key + 1):
                v = near.get(i, 0)
                if v > max_near:
                    max_near = v
                    max_pos = i
                    find = 1
                near.setdefault(i, 0)  # zombie entry (operator[])
        theclass += 1


def write_tfosorted_store(path: str, st: TriplexStore) -> None:
    """write_tfosorted on the columnar store (same row bytes)."""
    motif = st.cols.get("motif", np.empty(0, np.int32))
    order = native.sort_by_motif(np.ascontiguousarray(motif, np.int32))
    st.open_strings()
    c = st.cols
    with open(path, "w") as f:
        f.write("QueryStart\tQueryEnd\tStartInSeq\tEndInSeq\tDirection\t"
                "Chr\tStartInGenome\tEndInGenome\tMeanStability\t"
                "MeanIdentity(%)\tStrand\tRule\tScore\tNt(bp)\tClass\t"
                "MidPoint\tCenter\tTFO sequence\tTTS sequence\n")
        for i in order:
            if motif[i] == 0:
                continue
            d = "R" if c["starj"][i] < c["endj"][i] else "L"
            sa, sb = st.strings(i)
            f.write(f"{c['stari'][i]}\t{c['endi'][i]}\t{c['starj'][i]}\t"
                    f"{c['endj'][i]}\t{d}\t{st.chro(i)}\t"
                    f"{c['genomestart'][i]}\t{c['genomeend'][i]}\t"
                    f"{_fmt_f(c['tri_score'][i])}\t"
                    f"{_fmt_f(c['identity'][i])}\t"
                    f"{get_strand(c['reverse'][i], c['strand'][i])}\t"
                    f"{c['rule'][i]}\t{_fmt_f(c['score'][i])}\t"
                    f"{c['nt'][i]}\t{motif[i]}\t{c['middle'][i]}\t"
                    f"{c['center'][i]}\t{sa}\t{sb}\n")


def print_result_store(p: Params, species: str, lnc_name: str,
                       st: TriplexStore, chro_tag: str, dna_size: int,
                       start_genome: int,
                       stdout_compat: bool = False) -> str:
    """printResult on the columnar store (mirrors output.print_result)."""
    file_name = p.file1path[: len(p.file1path) - 3]
    out_path = (p.outpath + "/" + species + "-" + lnc_name + "-"
                + file_name + "-TFOsorted")
    class1: list[dict[int, int]] = [dict() for _ in range(6)]
    cluster_store(p.c_distance, p.c_length, st, class1, 5)
    write_tfosorted_store(out_path, st)
    prev = "\x7f"
    for level in (1, 2):
        if stdout_compat:
            print(f"{prev}{level}")
            prev = str(level)
        write_cluster(level, class1[level], start_genome - 1, chro_tag,
                      dna_size, lnc_name, p.c_distance, p.c_length,
                      out_path, str(p.c_distance), str(p.c_length))
    st.close()
    return out_path
