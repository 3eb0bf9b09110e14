"""Scan pipeline: segments -> transforms -> peaks -> candidates -> triplexes.

Reproduces LongTarget (Fasim-LongTarget.cpp:379-598) + fastSIM
(fastsim.h:158-289) + convertMyTriplex (fastsim.h:291-414) semantics exactly.
The two hot DP passes are delegated to a swappable engine (NumPy golden or
the device engine); everything candidate-level runs on host.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import native, rules
from ..config import GAP_EXTEND, GAP_OPEN, TOP_N, Params
from ..io import fasta
from ..kernels import align as kalign
from ..kernels.batch_np import numpy_engine

f32 = np.float32


@dataclasses.dataclass
class Triplex:
    """struct triplex (sim.h:20-45), host-side."""

    stari: int
    endi: int
    starj: int
    endj: int
    strand: int
    reverse: int  # Para
    rule: int
    nt: int
    score: np.float32
    identity: np.float32
    tri_score: np.float32
    stri_align: str  # RNA aligned (read_align)
    strj_align: str  # source DNA aligned (ref_align_src)
    middle: int = 0
    center: int = 0
    motif: int = 0
    neartriplex: int = 0
    genomestart: int = 0
    genomeend: int = 0
    chr: str = ""


def _get_alignment(al: kalign.Alignment, ref_seq: np.ndarray,
                   read_seq: np.ndarray, ref_seq_src: np.ndarray
                   ) -> tuple[str, str, str]:
    """getAlignment (fastsim.h:416-560): cigar -> (ref_align, read_align,
    ref_align_src).  The reference's 60-column chunking only affects
    printing; the concatenated strings are a plain cigar walk."""
    ref_a, read_a, src_a = [], [], []
    q = al.ref_begin
    p = al.query_begin
    for length, op in al.cigar:
        for _ in range(length):
            if op == "I":
                ref_a.append("-")
                src_a.append("-")
                read_a.append(chr(read_seq[p]))
                p += 1
            elif op == "D":
                ref_a.append(chr(ref_seq[q]))
                src_a.append(chr(ref_seq_src[q]))
                read_a.append("-")
                q += 1
            else:  # M
                ref_a.append(chr(ref_seq[q]))
                src_a.append(chr(ref_seq_src[q]))
                read_a.append(chr(read_seq[p]))
                q += 1
                p += 1
    return "".join(ref_a), "".join(read_a), "".join(src_a)


def _convert_triplex(al: kalign.Alignment, out: list[Triplex],
                     read_seq: np.ndarray, ref_seq: np.ndarray,
                     ref_seq_src: np.ndarray, dna_start_pos: int,
                     rule: int, strand: int, para: int, p: Params) -> None:
    """convertMyTriplex (fastsim.h:291-414): aligned strings, identity,
    stability with TT/CC run penalties, coordinate flip, push."""
    ref_align, read_align, ref_align_src = _get_alignment(
        al, ref_seq, read_seq, ref_seq_src)
    nt = len(ref_align)
    match = sum(1 for a, b in zip(ref_align, read_align) if a == b)
    mis = nt - match
    identity = f32(f32(100 * match) / f32(match + mis))
    tri_score = f32(0.0)
    if p.nt_min <= nt <= p.nt_max:
        prechar = "\0"
        prescore = f32(0.0)
        stab = rules.STAB_PARA if para > 0 else rules.STAB_ANTI
        pen_t = f32(p.penalty_t)
        pen_c = f32(p.penalty_c)
        for i in range(nt):
            curchar = "-" if ref_align[i] == "-" else ref_align_src[i]
            hashvalue = stab[ord(curchar), ord(read_align[i])]
            if curchar == prechar and curchar == "T":
                tri_score = f32(f32(tri_score - prescore) + pen_t)
                hashvalue = pen_t
            if curchar == prechar and curchar == "C":
                tri_score = f32(f32(tri_score - prescore) + pen_c)
                hashvalue = pen_c
            prescore = hashvalue
            if ref_align[i] != "-":
                prechar = curchar
            tri_score = f32(tri_score + hashvalue)
        tri_score = f32(tri_score / f32(nt))
    if (para > 0 and strand == 1) or (para < 0 and strand == 0):
        ref_start = len(ref_seq) - al.ref_end - 1
        ref_end = len(ref_seq) - al.ref_begin - 1
    else:
        ref_start = al.ref_begin + 1
        ref_end = al.ref_end + 1
    if nt >= p.nt_min:
        out.append(Triplex(
            stari=al.query_begin + 1, endi=al.query_end + 1,
            starj=ref_start + dna_start_pos, endj=ref_end + dna_start_pos,
            strand=strand, reverse=para, rule=rule, nt=nt,
            score=f32(al.sw_score), identity=identity, tri_score=tri_score,
            stri_align=read_align, strj_align=ref_align_src))


_enc_cache: dict[bytes, np.ndarray] = {}


def _enc_i32(seq: np.ndarray, key: bytes) -> np.ndarray:
    """Cached SSW encoding of a hot sequence (the query repeats across
    every (segment, transform) pair)."""
    enc = _enc_cache.get(key)
    if enc is None:
        enc = np.ascontiguousarray(rules.SSW_ENC[seq], np.int32)
        if len(_enc_cache) > 4:
            _enc_cache.clear()
        _enc_cache[key] = enc
    return enc


def _fast_sim(rna: np.ndarray, seq2: np.ndarray, src: np.ndarray,
              dna_start_pos: int, min_score: int, colmax: np.ndarray,
              strand: int, para: int, rule: int, p: Params,
              out: list[Triplex]) -> None:
    """fastSIM (fastsim.h:158-289) with the colmax pass precomputed, via
    the native runtime (one GIL-releasing call per pair; the Python model
    below, _fast_sim_py, is its differential-test target)."""
    rna_b = rna.tobytes()
    for (stari, endi, starj, endj, nt, score, identity, tri_score,
         ri, rj) in native.fastsim_pair(
            _enc_i32(rna, rna_b),
            np.ascontiguousarray(rules.SSW_ENC[seq2], np.int32),
            rna_b, seq2.tobytes(), src.tobytes(),
            np.ascontiguousarray(colmax, np.int32), rules.SSW_MAT,
            GAP_OPEN, GAP_EXTEND, dna_start_pos, min_score, strand, para,
            p.nt_min,
            p.nt_max, p.penalty_t, p.penalty_c, f32(p.min_identity),
            f32(p.min_stability)):
        out.append(Triplex(
            stari=stari, endi=endi, starj=starj, endj=endj, strand=strand,
            reverse=para, rule=rule, nt=nt, score=f32(score),
            identity=f32(identity), tri_score=f32(tri_score),
            stri_align=ri, strj_align=rj))


def _fast_sim_py(rna: np.ndarray, seq2: np.ndarray, src: np.ndarray,
                 dna_start_pos: int, min_score: int, colmax: np.ndarray,
                 strand: int, para: int, rule: int, p: Params,
                 out: list[Triplex]) -> None:
    """Golden Python model of the fastSIM candidate stage."""
    peaks = kalign.prealign_peaks(colmax, min_score)
    q_idx = rules.SSW_ENC[rna]
    r_idx_full = rules.SSW_ENC[seq2]
    cands: list[Triplex] = []
    for score, position in peaks:
        iden = f32(0.6)
        best = kalign.Alignment()
        best_cutlength = 0
        myflag = 0
        al = kalign.Alignment()
        cutlength = 0
        while iden <= 1:
            cutlength = int(f32(f32(score + 24) / f32(f32(9) * iden - f32(4)))
                            + f32(1))
            if position - cutlength + 1 <= 0:
                cutlength = position + 1
            al = kalign.align_window(
                q_idx, r_idx_full[position - cutlength + 1: position + 1],
                rules.SSW_MAT)
            if al.sw_score >= score:
                myflag = 1
                break
            if al.sw_score > best.sw_score and al.ref_end == cutlength - 1:
                best = al
                best_cutlength = cutlength
                myflag = 2
            iden = f32(iden + 0.1)
        if myflag == 2:
            al = best
            cutlength = best_cutlength
        if al.sw_score != 0:
            al = dataclasses.replace(
                al,
                ref_begin=al.ref_begin + position - cutlength + 1,
                ref_end=al.ref_end + position - cutlength + 1)
            _convert_triplex(al, cands, rna, seq2, src, dna_start_pos,
                             rule, strand, para, p)
    # dedup / top-N / filter (fastsim.h:273-288)
    if cands:
        keep = native.fastsim_dedup(
            np.array([t.stari for t in cands], np.int32),
            np.array([t.endi for t in cands], np.int32),
            np.array([t.starj for t in cands], np.int32),
            np.array([t.endj for t in cands], np.int32),
            np.array([t.score for t in cands], np.float32))
        for i in keep[:TOP_N]:
            t = cands[i]
            if (t.identity >= f32(p.min_identity)
                    and t.tri_score >= f32(p.min_stability)
                    and t.nt >= p.nt_min):
                out.append(t)


def _sim(rna: np.ndarray, seq2: np.ndarray, src: np.ndarray,
         dna_start_pos: int, min_score: int, strand: int, para: int,
         rule: int, p: Params, out: list[Triplex]) -> None:
    """SIM exact engine (sim.h:410-1143) via the native runtime; emits
    Triplex records with the reference's field semantics."""
    for (stari, endi, starj, endj, nt, score, identity, tri_score,
         ri, rj) in native.sim_scan(
            rna.tobytes(), seq2.tobytes(), src.tobytes(), dna_start_pos,
            min_score, strand, para, p.nt_min, p.nt_max, p.penalty_t,
            p.penalty_c):
        out.append(Triplex(
            stari=stari, endi=endi, starj=starj, endj=endj, strand=strand,
            reverse=para, rule=rule, nt=nt, score=f32(score),
            identity=f32(identity), tri_score=f32(tri_score),
            stri_align=ri, strj_align=rj))


def long_target(p: Params, rna: np.ndarray, dna: np.ndarray,
                engine=numpy_engine) -> list[Triplex]:
    """LongTarget (Fasim-LongTarget.cpp:379-598) for one DNA record."""
    segs, starts = fasta.cut_sequence(dna, p.cut_length, p.overlap_length)
    triplex_list: list[Triplex] = []
    for seg, start in zip(segs, starts):
        if fasta.same_seq(seg):
            continue
        scans = rules.scan_list(p.rule, p.strand)
        pairs = [rules.make_scan_strings(seg, s) for s in scans]
        thresh, colmax = engine(rna, [s2 for s2, _ in pairs])
        for k, scan in enumerate(scans):
            min_score = int(int(thresh[k]) * 0.8)
            if p.do_fast_sim:
                _fast_sim(rna, pairs[k][0], pairs[k][1], start, min_score,
                          colmax[k], scan["strand"], scan["para"],
                          scan["rule"], p, triplex_list)
            else:
                _sim(rna, pairs[k][0], pairs[k][1], start, min_score,
                     scan["strand"], scan["para"], scan["rule"], p,
                     triplex_list)
    # final filter (Fasim-LongTarget.cpp:589-597)
    return [t for t in triplex_list
            if (t.score >= f32(p.score_min) and t.identity >= f32(p.min_identity)
                and t.tri_score >= f32(p.min_stability) and t.nt >= p.c_length)]


def scan_file(p: Params, engine=numpy_engine):
    """main's per-record loop (Fasim-LongTarget.cpp:121-163).  Returns
    (records, lnc_name, rna, all_triplexes).  With -C corenum >= 2 the
    reference round-robins each record's hits into corenum buckets and
    concatenates the buckets (:129-163) — a pure list permutation (no
    threads are spawned), emulated here for byte parity."""
    records = fasta.read_dna(p.file1path)
    lnc_name, rna = fasta.read_rna(p.file2path)
    buckets: list[list[Triplex]] = [[] for _ in range(max(1, p.corenum))]
    for i, rec in enumerate(records):
        lst = long_target(p, rna, rec.seq, engine)
        for t in lst:
            if t.genomestart == 0:
                t.chr = rec.chro_tag
                t.genomestart = t.starj + rec.start_genome - 1
                t.genomeend = t.endj + rec.start_genome - 1
        buckets[i % len(buckets)].extend(lst)
    return records, lnc_name, rna, [t for b in buckets for t in b]
