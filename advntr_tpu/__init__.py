"""adVNTR-TPU: a JAX framework for genotyping Variable Number Tandem Repeats.

A from-scratch reimplementation of the capabilities of adVNTR (Bakhtiari et al.,
Genome Research 2018) built around batched accelerator kernels:

- profile-HMM Viterbi decoding runs as batched, padded log-space dynamic
  programming on device (JAX/XLA), replacing the
  reference's per-read Cython graph DP (reference: pomegranate/hmm.pyx:1970).
- silent states (delete chains, unit boundaries) are eliminated at model-compile
  time via a max-plus transitive closure, so the device kernel sees a clean
  first-order HMM over emitting states; an auxiliary decode table re-expands
  collapsed silent hops for exact repeat-unit counting
  (reference semantics: pomegranate/hmm.pyx:2025-2083).
- read recruitment is a vectorized k-mer hash-membership kernel
  (capability-equivalent to the reference's Aho-Corasick C++ filter,
  filtering/main.cc).
- multi-locus / multi-read scale-out uses jax.sharding over a device mesh.
"""

__version__ = "0.1.0"
