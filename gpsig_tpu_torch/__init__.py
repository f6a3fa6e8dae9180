"""gpsig_tpu_torch — signature-kernel Gaussian processes in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (H100).

The port of ``gpsig_tpu`` (JAX), which stays the reference; the module
layout and public names mirror it. Importing needs neither JAX nor a CUDA
toolkit: the kernels in ``csrc/`` are built at the first launch on a CUDA
tensor. CPU tensors take the plain PyTorch path.
"""

from gpsig_tpu_torch.kernels.signature import (  # noqa: F401
    SignatureCosine,
    SignatureKernel,
    SignatureLinear,
    SignaturePoly,
    SignatureRBF,
)
from gpsig_tpu_torch.kernels.pde import UntruncatedSignatureKernel  # noqa: F401
from gpsig_tpu_torch.kernels.low_rank import (  # noqa: F401
    LowRankSignatureKernel,
    LowRankSignatureRBF,
)
from gpsig_tpu_torch.kernels.vosf import (  # noqa: F401
    ExplicitSignatureKernel,
    OrthogonalSignatureFeatures,
)
from gpsig_tpu_torch.inducing import (  # noqa: F401
    InducingSequences,
    InducingTensors,
    make_inducing_sequences_from_data,
    make_inducing_tensors_from_data,
)
from gpsig_tpu_torch.models.gpr import GPR  # noqa: F401
from gpsig_tpu_torch.models.svgp import SVGP  # noqa: F401
from gpsig_tpu_torch import likelihoods  # noqa: F401

__version__ = "0.1.0"
