"""dca_tpu_torch — the deep count autoencoder on PyTorch and CUDA.

The PyTorch port of the JAX package ``dca_tpu``, for NVIDIA Hopper cards.
``dca(adata)`` and ``python -m dca_tpu_torch in.tsv out/`` train and
denoise every architecture of the JAX package (``normal``, ``poisson``, the
NB family ``nb``, ``nb-conddisp``, ``nb-shared``, ``nb-fork`` and the ZINB
family ``zinb``, ``zinb-conddisp``, ``zinb-shared``, ``zinb-fork``,
``zinb-elempi``), with the NB and ZINB losses and their gradients computed
by CUDA kernels written for ``sm_90a`` (``csrc/``, built at first use).  The
entry points run on the CUDA device unless the caller passes
``device="cpu"``.

The package imports neither JAX nor ``dca_tpu``.  What remains to port is
listed in ROADMAP.md.
"""

__version__ = "0.1.0"

from .api import dca
from .models import AE_types

__all__ = ["dca", "AE_types", "__version__"]
