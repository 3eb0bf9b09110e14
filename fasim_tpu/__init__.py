"""fasim_tpu — a JAX triplex-scanning framework for NVIDIA GPUs.

A from-scratch reimplementation of the capabilities of LongTarget/Fasim-LongTarget
designed for an accelerator (an NVIDIA H100):

  * the two hot Smith-Waterman passes (threshold/scan per-column-max pass
    and the candidate-window pass) run as CUDA kernels called through
    `jax.ffi`, batched over the 48 pairing-rule transforms and over DNA
    segments, with plain-XLA forms as their reference and CPU engine;
  * batches round-robin over the local cards; a multi-host runner shards
    the segment stream across processes;
  * the candidate-window traceback and the global clustering/output
    stages run in a small native C++ runtime whose results are
    bit-identical to the reference implementation.

Layering (top to bottom): cli -> scan pipeline -> {kernels (device), native
runtime} with io/rules/config shared, and dist providing the multi-host glue.
"""

__version__ = "0.1.0"
