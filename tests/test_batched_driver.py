"""Batched device driver vs sequential pipeline (H19 demo, XLA engine)."""

import dataclasses
import os

import numpy as np

from conftest import ORACLE

from fasim_tpu.config import Params
from fasim_tpu.io import fasta
from fasim_tpu.kernels.xla import XlaScanEngine
from fasim_tpu.scan import batched, pipeline


def test_batched_scan_matches_sequential():
    p = Params(file1path=os.path.join(ORACLE, "testDNA.fa"),
               file2path=os.path.join(ORACLE, "H19.fa"))
    records, lnc, rna, seq_t = pipeline.scan_file(p)
    eng = XlaScanEngine(rna)
    # small batch size to exercise batching boundaries
    _, _, _, bat_t = batched.scan_file_batched(p, eng, batch_pairs=1)
    assert len(seq_t) == len(bat_t)
    for a, b in zip(seq_t, bat_t):
        assert dataclasses.astuple(a) == dataclasses.astuple(b)


def test_stream_matches_batched_multirecord(tmp_path, monkeypatch):
    """Streaming (lazy-record, columnar spill store) scan == list scan
    on multi-record input: record metadata AND every output file byte-
    identical through the full cluster/print path, with and without the
    -C bucket permutation."""
    from fasim_tpu.post.output import print_result

    monkeypatch.chdir(ORACLE)  # output names embed the -f1 path
    for corenum in (1, 3):
        p = Params(file1path="meg3sub3.fa",
                   file2path=os.path.join(ORACLE, "MEG3.fa"),
                   outpath=str(tmp_path / f"b{corenum}"),
                   corenum=corenum)
        os.makedirs(p.outpath, exist_ok=True)
        _, rna = fasta.read_rna(p.file2path)
        eng = XlaScanEngine(rna)
        recs, lnc, _, bat_t = batched.scan_file_batched(
            p, eng, batch_pairs=3)
        path_b = print_result(p, recs[0].species, lnc, bat_t,
                              recs[0].chro_tag, len(recs[0].seq),
                              recs[0].start_genome)
        eng2 = XlaScanEngine(rna)
        p2 = dataclasses.replace(p, outpath=str(tmp_path / f"s{corenum}"))
        os.makedirs(p2.outpath, exist_ok=True)
        metas, lnc2, _, store = batched.scan_file_stream(
            p2, eng2, batch_pairs=3, spill_dir=str(tmp_path / "spill"))
        assert len(metas) == len(recs)
        for m, r in zip(metas, recs):
            assert (m.species, m.chro_tag, m.start_genome, m.seq_len) == (
                r.species, r.chro_tag, r.start_genome, len(r.seq))
        assert len(store) == len(bat_t) > 0
        path_s = print_result(p2, metas[0].species, lnc2, store,
                              metas[0].chro_tag, metas[0].seq_len,
                              metas[0].start_genome)
        for f in sorted(os.listdir(p.outpath)):
            with open(os.path.join(p.outpath, f), "rb") as fa, \
                    open(os.path.join(p2.outpath, f), "rb") as fb:
                assert fa.read() == fb.read(), (corenum, f)
        assert os.path.basename(path_b) == os.path.basename(path_s)


def test_watchdog_raises_on_wedged_batch(monkeypatch):
    """A batch whose device stage never completes surfaces as a clear
    RuntimeError (FASIM_WATCHDOG_S), not an indefinite hang."""
    import threading

    import pytest

    from fasim_tpu import rules

    p = Params(file1path=os.path.join(ORACLE, "testDNA.fa"),
               file2path=os.path.join(ORACLE, "H19.fa"))
    _, rna = fasta.read_rna(p.file2path)
    eng = XlaScanEngine(rna)
    hang = threading.Event()

    class WedgedEngine:
        """Delegates setup to the real engine; the scan never returns."""

        def __init__(self, inner):
            self._inner = inner

        def __getattr__(self, name):
            return getattr(self._inner, name)

        def scan_segments(self, segs, lengths):
            hang.wait(60)  # simulates a device call that never returns
            raise AssertionError("watchdog did not fire")

        def scan_segments_packed(self, segs, lengths):
            return self.scan_segments(segs, lengths)

    monkeypatch.setenv("FASIM_WATCHDOG_S", "2")
    # release the wedged stage thread once the watchdog has fired, so
    # the driver's executors can shut down
    threading.Timer(5, hang.set).start()
    scans = rules.scan_list(0, 0)
    work = [batched._Work(0, 0, rec.seq[:640])
            for rec in fasta.read_dna(p.file1path)]
    with pytest.raises(RuntimeError, match="watchdog"):
        list(batched.iter_scan_work(p, rna, iter(work), scans,
                                    WedgedEngine(eng), 640,
                                    batch_pairs=1, max_inflight=1))
    hang.set()
