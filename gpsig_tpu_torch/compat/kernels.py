"""GPSig-style kernel classes (reference: ``gpsig/kernels.py``).

Counterpart of ``gpsig_tpu/compat/kernels.py``. The constructors take
``input_dim`` (the flattened ``L*d``) first; the methods accept flattened
``[N, L*d]`` (or ``[N, L, d]``) inputs; ``K``, ``Kdiag``, ``K_tens``,
``K_tens_vs_seq``, ``K_tens_diag`` and ``feature`` return tensors on the
kernel's device, and their ``compute_*`` twins return numpy arrays.
``low_rank=True`` switches to the Nyström + sketched-Hadamard feature path
(``num_components``, ``rank_bound``, ``sparsity``).

Deviations from the JAX facade:

- Inputs are cast to the kernel's dtype and device. Where ``jnp`` would
  promote a float32 kernel on float64 input to float64, the port computes
  in float32.
- ``engine`` and ``row_block`` (the JAX package's TPU engine choices) are
  refused with a ``TypeError`` that names them; the PDE kernel keeps its
  ``engine``.
- The low-rank landmarks and pairs are drawn by
  ``torch.Generator().manual_seed(0)`` where JAX uses ``PRNGKey(0)``: the
  same sources in the same order of preference (``X_example``, then the
  training data of a compat ``SVGP``, then first touch), other values.
"""

from __future__ import annotations

import torch

from gpsig_tpu_torch import config
from gpsig_tpu_torch.kernels import low_rank as lr
from gpsig_tpu_torch.kernels import pde
from gpsig_tpu_torch.kernels import signature as core

#: keywords only the JAX package takes (its TPU engines): refused by name
_TPU_ONLY = ("engine", "row_block")


def _refuse(kw, names):
    for name in names:
        if name in kw:
            raise TypeError(
                f"{name}= chooses among the JAX package's TPU engines; "
                "gpsig_tpu_torch takes no such keyword")


def _numpy(t):
    return t.detach().cpu().numpy()


def _view(value):
    return None if value is None else _numpy(value)


class _Kernel:
    """What the truncated and the untruncated kernel share: the flattened
    input check, the casting of inputs, the functional handoff, and ``K``
    / ``Kdiag`` with their ``compute_*`` twins."""

    _low_rank = False

    def _setup(self, input_dim, num_features, dtype, device):
        if input_dim % num_features:
            raise ValueError(
                f"input_dim {input_dim} not divisible by num_features "
                f"{num_features}"
            )
        self.input_dim = input_dim
        self.num_features = num_features
        self.dtype = dtype or torch.float64
        self.device = config.resolve_device(device)

    # -- functional-core handoff -------------------------------------------
    def to_functional(self):
        """The underlying ``nn.Module``."""
        if self._kern is None:
            raise RuntimeError(
                "low_rank kernel is built on first use; call compute_K / "
                "feed it data first"
            )
        return self._kern

    def update_functional(self, kern):
        """Install another module in place of the wrapped one."""
        self._kern = kern

    def _ready(self, X):
        """The module, built from ``X`` first where it waits for data."""
        return self._kern

    # -- inputs ---------------------------------------------------------------
    def _tensor(self, A):
        """``A`` as a tensor in the kernel's dtype and on its device."""
        return torch.as_tensor(A, dtype=self.dtype, device=self.device)

    def _check(self, X):
        X = self._tensor(X)
        if X.ndim == 2 and X.shape[1] != self.input_dim:
            raise ValueError(
                f"expected flattened input_dim {self.input_dim}, got "
                f"{X.shape[1]}"
            )
        return X

    # -- parameter views ------------------------------------------------------
    @property
    def lengthscales(self):
        return _view(self._kern.lengthscales)

    @property
    def sigma(self):
        return _numpy(self._kern.sigma)

    # -- graph-style methods (tensors out) -----------------------------------
    def K(self, X, X2=None):
        X = self._check(X)
        kern = self._ready(X)
        return kern.K(X, None if X2 is None else self._check(X2))

    def Kdiag(self, X):
        X = self._check(X)
        return self._ready(X).Kdiag(X)

    # -- autoflow twins (numpy out) -------------------------------------------
    def compute_K(self, X, X2):
        with torch.no_grad():
            return _numpy(self.K(X, X2))

    def compute_K_symm(self, X):
        with torch.no_grad():
            return _numpy(self.K(X))

    def compute_Kdiag(self, X):
        with torch.no_grad():
            return _numpy(self.Kdiag(X))


class SignatureKernel(_Kernel):
    """Stateful wrapper over the port's signature kernel module.

    Parameters follow the reference's ``SignatureKernel.__init__``:
    ``input_dim`` = L*d of the flattened sequences, ``num_features`` = d.
    Parameter attributes (``lengthscales``, ``variances``, ``sigma``,
    ``lags``, ``gamma``) read as numpy.
    """

    _CTOR = staticmethod(core.SignatureRBF)

    def __init__(
        self,
        input_dim,
        num_features,
        num_levels,
        order=1,
        variances=None,
        lengthscales=1.0,
        normalization=True,
        difference=True,
        num_lags=0,
        low_rank=False,
        num_components=64,
        rank_bound=None,
        sparsity="sqrt",
        X_example=None,
        dtype=None,
        device=None,
        **kw,
    ):
        _refuse(kw, _TPU_ONLY)
        self._setup(input_dim, num_features, dtype, device)
        self.num_levels = num_levels
        self.num_len = input_dim // num_features
        self._low_rank = bool(low_rank)
        if low_rank:
            if type(self) not in (SignatureKernel, SignatureRBF):
                # the reference's low-rank branch exists for the RBF/Gauss
                # base only (Nyström landmarks of the RBF base kernel)
                raise NotImplementedError(
                    "low_rank=True is supported for SignatureRBF"
                )
            if order != 1 or num_lags != 0:
                raise NotImplementedError(
                    "low_rank=True supports order=1, num_lags=0"
                )
            self._lr_init = dict(
                num_components=num_components,
                rank_bound=rank_bound,
                sparsity=sparsity,
                lengthscales=lengthscales,
                variances=variances,
                normalization=normalization,
                difference=difference,
                dtype=self.dtype,
                device=self.device,
            )
            # Nyström landmarks need data. Sources, in order of preference:
            # X_example here, the training data when the kernel is handed to
            # a compat SVGP (models.py calls _ensure_low_rank(X_train)), and
            # only then first-touch data.
            self._kern = None
            if X_example is not None:
                self._ensure_low_rank(self._check(X_example))
        else:
            self._kern = type(self)._CTOR(
                num_features,
                num_levels,
                order=order,
                variances=variances,
                lengthscales=lengthscales,
                normalization=normalization,
                difference=difference,
                num_lags=num_lags,
                dtype=self.dtype,
                device=self.device,
                **kw,
            )

    def _ensure_low_rank(self, X):
        if self._kern is None:
            self._kern = lr.LowRankSignatureRBF(
                torch.Generator().manual_seed(0),
                X,
                self.num_features,
                self.num_levels,
                **self._lr_init,
            )

    def _ready(self, X):
        if self._low_rank:
            self._ensure_low_rank(X)
        return self._kern

    # -- parameter views ------------------------------------------------------
    @property
    def variances(self):
        return _numpy(self._kern.variances)

    @property
    def lags(self):
        return _view(getattr(self._kern, "lags", None))

    @property
    def gamma(self):
        return _view(getattr(self._kern, "gamma", None))

    # -- inducing-tensor methods ----------------------------------------------
    def K_tens(self, Z, increments=False):
        return self._kern.K_tens(self._tensor(Z), increments=increments)

    def K_tens_vs_seq(self, Z, X, increments=False):
        return self._kern.K_tens_vs_seq(self._tensor(Z), self._check(X),
                                        increments=increments)

    def K_tens_diag(self, Z, increments=False):
        return self._kern.K_tens_diag(self._tensor(Z), increments=increments)

    def feature(self, X):
        """Low-rank path: explicit feature map Φ with K ≈ ΦΦᵀ."""
        if not self._low_rank:
            raise AttributeError("feature() requires low_rank=True")
        X = self._check(X)
        return self._ready(X).feature(X)

    def compute_K_tens(self, Z, increments=False):
        with torch.no_grad():
            return _numpy(self.K_tens(Z, increments=increments))

    def compute_K_tens_vs_seq(self, Z, X, increments=False):
        with torch.no_grad():
            return _numpy(self.K_tens_vs_seq(Z, X, increments=increments))

    def compute_K_tens_diag(self, Z, increments=False):
        with torch.no_grad():
            return _numpy(self.K_tens_diag(Z, increments=increments))


class SignatureRBF(SignatureKernel):
    _CTOR = staticmethod(core.SignatureRBF)


#: the reference also calls the RBF base "Gauss"
SignatureGauss = SignatureRBF


class SignatureLinear(SignatureKernel):
    _CTOR = staticmethod(core.SignatureLinear)


class SignaturePoly(SignatureKernel):
    _CTOR = staticmethod(core.SignaturePoly)


class SignatureCosine(SignatureKernel):
    _CTOR = staticmethod(core.SignatureCosine)


class UntruncSignatureKernel(_Kernel):
    """The fork's PDE (Goursat) signature kernel (reference:
    ``gpsig/kernels_pde.py::UntruncSignatureKernel``), with the reference's
    flattened-input and ``compute_K*`` conventions."""

    def __init__(self, input_dim, num_features, dyadic_order=0,
                 lengthscales=1.0, sigma=1.0, normalization=False,
                 dtype=None, device=None, **kw):
        _refuse(kw, ("row_block",))
        self._setup(input_dim, num_features, dtype, device)
        self._kern = pde.UntruncatedSignatureKernel.create(
            num_features,
            lengthscales=lengthscales,
            sigma=sigma,
            dyadic_order=dyadic_order,
            normalization=normalization,
            dtype=self.dtype,
            device=self.device,
            **kw,
        )
