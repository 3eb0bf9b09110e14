"""Run configuration.

Field names, defaults and semantics mirror the reference CLI surface
(`struct para`, /root/reference/fastsim.h:22-45, defaults at
/root/reference/Fasim-LongTarget.cpp:284-303) so that a reference user can
switch over without relearning flags.  Framework-native knobs (mesh shape,
batching, engine choice) live in `TpuConfig`.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Params:
    """Scan parameters (reference flag in parentheses).

    Note the reference parses `-i` and `-S` with atoi() even though the
    fields are floats (Fasim-LongTarget.cpp:340,343); the CLI layer
    reproduces that truncation, while this dataclass keeps floats so the
    API is usable directly.
    """

    file1path: str = "./"          # -f1 DNA fasta
    file2path: str = "./"          # -f2 RNA fasta
    outpath: str = "./"            # -O output directory
    rule: int = 0                  # -r  0 = all rules, 1..6 para / 1..18 anti
    cut_length: int = 5000         # -c  DNA segment length
    strand: int = 0                # -t  >=0 scans para rules, <=0 scans anti rules
    overlap_length: int = 100      # -o  segment overlap
    min_score: int = 0             # -m  (kept for CLI parity; unused by scan)
    detail_output: bool = False    # -d
    nt_min: int = 20               # -ni triplex min length
    nt_max: int = 100000           # -na triplex max length
    score_min: float = 0.0         # (scoreMin; no flag sets it — always 0)
    min_identity: float = 60.0     # -i
    min_stability: float = 1.0     # -S
    penalty_t: int = -1000         # -pt consecutive-T penalty
    penalty_c: int = 0             # -pc consecutive-C penalty
    c_distance: int = 15           # -ds cluster distance dd
    c_length: int = 50             # -lg cluster length threshold
    do_fast_sim: bool = True       # -F flips to False (exact SIM engine)
    corenum: int = 1               # -C (reference: accepted but single-threaded)


@dataclasses.dataclass
class TpuConfig:
    """Device-path knobs (no reference counterpart; the historical name
    and the --tpu-* flag prefix are kept for existing command lines)."""

    # Scan engine: auto or xla (the device engine, kernels/xla.py: the
    # CUDA kernels on a GPU, plain XLA elsewhere), or numpy (golden
    # reference path, per-segment, host only).
    engine: str = "auto"
    # Number of DNA segments processed per kernel launch (batch dim).
    segments_per_batch: int = 64
    # Data-parallel mesh axis size; 0 = use all local devices.
    dp_devices: int = 0
    # Print the per-stage wall-clock split on stderr after the run.
    profile: bool = False
    # Max device batches in flight per device (bounds host + device
    # memory at genome scale); 0 = dispatch everything up front.
    max_inflight: int = 4
    # Reproduce the reference's stdout progress lines (lncName,
    # "dnaPos = N" per segment, the print_cluster level-quirk lines and
    # "Running time is ..."; Fasim-LongTarget.cpp:192,398,698,170).
    stdout_compat: bool = False
    # Streaming record reader for genome-scale inputs: "auto" streams
    # when the DNA file exceeds 32 MB; "on"/"off" force it.
    stream: str = "auto"
    # -F only: run the SIM forward scan on the device (kernels/sim_dev)
    # with host node-list replay.  Bit-identical (tests/test_sim.py); off
    # by default, where the 48 transform pairs fan out over host cores.
    # Also honors env FASIM_SIM_DEVICE=1.
    sim_device: bool = False


# Alignment scoring constants shared by both engines
# (gap open 16 / extend 4: stats.h:803 '\020','\004'; ssw_cpp.cpp:244-245).
GAP_OPEN = 16
GAP_EXTEND = 4
MATCH = 5
MISMATCH = -4

# Saturation threshold of the reference byte kernels: an 8-bit cell with
# bias 4 saturates when score+4 >= 255, i.e. score >= 251
# (stats.h:729, sswNew.cpp:386,423).
BYTE_SAT = 251

# fastSIM keeps at most this many triplexes per (segment, transform)
# (fastsim.h:8  #define N 50).
TOP_N = 50

# SIM keeps at most this many best nodes (sim.h:17  #define K 50).
SIM_K = 50
