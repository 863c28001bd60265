"""multiclust-tpu on PyTorch and CUDA: the admixture and mixture models on
one GPU.

A second package beside the JAX reference (``multiclust_tpu``), mirroring
its layout module for module.  The JAX-free host layer of the reference
(``config.Options``, ``messages``, ``io/*``, ``stats/sim``,
``model/likelihood``, ``cli.parse_args``) is imported, not copied; this
package imports ``torch`` and never ``jax``.

The EM steps run as hand-written CUDA kernels (``csrc/*.cu``: biallelic
and generic admixture, biallelic mixture; built with nvcc at first use
into ``build/``); on CPU tensors every kernel wrapper runs its plain
PyTorch version.
"""

__version__ = "0.1.0"
