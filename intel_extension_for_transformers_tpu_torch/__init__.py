"""PyTorch + CUDA port of the GenAI toolkit, for NVIDIA Hopper (H100).

The JAX package `intel_extension_for_transformers_tpu` is the reference; this
package keeps its module paths and public names, so each function here has a
counterpart of the same name there. Plain tensor code is PyTorch; each kernel
the JAX package wrote in Pallas is a hand-written CUDA kernel under `csrc/`,
built with nvcc at first use (`ops/kernels.py`).

Ported so far: the RAG retrieval path (parse → chunk → INT4 BGE encode →
int4 flat index → rerank → QA prompt). Importing the package imports neither
jax nor the JAX package.
"""

__version__ = "0.1.0"
