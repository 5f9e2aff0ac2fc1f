"""oarfish_tpu — long-read RNA-seq transcript quantification in JAX.

A from-scratch JAX/XLA re-design with the capabilities of
COMBINE-lab/oarfish: host-side streaming BAM decoding packs a sparse
read×transcript CSR; the EM abundance update, coverage models, and
bootstrap inferential replicates run on device; reads shard
data-parallel across a device mesh with per-iteration `psum` of partial
transcript counts.
"""

__version__ = "0.1.0"
