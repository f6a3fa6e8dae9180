"""Parity of the PyTorch port's parameter transforms, numeric policy and
plain order-1 signature recursions with ``gpsig_tpu`` (float64, CPU); the
higher-order recursions are ``test_torch_higher_order.py``'s.

Tolerances: both sides run the same float64 formulas op for op, so they
agree to rounding (rtol 1e-10); the recursions sum in another order than
XLA, which moves the last few bits only.
"""

import subprocess
import sys
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpsig_tpu import config as jcfg
from gpsig_tpu import params as jpr
from gpsig_tpu.ops import signature as jsig
from gpsig_tpu_torch import config as tcfg
from gpsig_tpu_torch import params as tpr
from gpsig_tpu_torch.ops import signature as tsig

torch.set_num_threads(1)
RTOL = 1e-10
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("name", ["softplus", "inv_softplus", "positive",
                                  "inv_positive", "logistic", "inv_logistic"])
def test_params_transform_matches_jax(name):
    rng = np.random.default_rng(0)
    x = rng.uniform(0.01, 0.99, 16) if "inv" in name else \
        rng.normal(0, 10, 16)
    x = np.concatenate([x, [25.0 if "softplus" in name else 0.5]])
    want = np.asarray(getattr(jpr, name)(jnp.asarray(x)))
    got = getattr(tpr, name)(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_vec_to_tril_matches_jax():
    v = np.arange(1.0, 11.0)
    want = np.asarray(jpr.vec_to_tril(jnp.asarray(v), 4))
    got = tpr.vec_to_tril(torch.as_tensor(v), 4)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("tdt,jdt", [(torch.float32, jnp.float32),
                                     (torch.float64, jnp.float64)])
def test_default_jitter_is_dtype_aware(tdt, jdt):
    assert tcfg.default_jitter(tdt) == jcfg.default_jitter(jdt)
    assert tcfg.default_jitter(None) == jcfg.default_jitter(None)
    assert tcfg.default_jitter(torch.float32) == 1e-4


def test_precise_linalg_turns_tf32_off_and_restores():
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    before = (matmul.allow_tf32, cudnn.allow_tf32)
    matmul.allow_tf32 = cudnn.allow_tf32 = True
    try:
        with tcfg.precise_linalg():
            assert not matmul.allow_tf32 and not cudnn.allow_tf32

        @tcfg.precise_linalg()
        def inside():
            return matmul.allow_tf32, cudnn.allow_tf32

        assert inside() == (False, False)
        assert matmul.allow_tf32 and cudnn.allow_tf32
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = before


def test_ecumsum_and_incremental_gram_match_jax():
    K = np.random.default_rng(1).standard_normal((3, 7, 6))
    np.testing.assert_allclose(
        tsig.ecumsum2(_t(K)).numpy(), np.asarray(jsig.ecumsum2(K)),
        rtol=RTOL)
    np.testing.assert_allclose(
        tsig.incremental_gram(_t(K)).numpy(),
        np.asarray(jsig.incremental_gram(K)), rtol=RTOL)


@pytest.mark.parametrize("nl", [1, 2, 4])
def test_signature_kern_order1_matches_jax(nl):
    M = 0.5 * np.random.default_rng(nl).standard_normal((2, 3, 9, 11))
    want = np.asarray(jsig.signature_kern(M, nl, order=1))
    got = tsig.signature_kern(_t(M), nl).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-14)


@pytest.mark.parametrize("nl", [1, 3, 4])
def test_signature_kern_tens_vs_seq_matches_jax(nl):
    F = tsig.tensor_factor_count(nl)
    assert F == jsig.tensor_factor_count(nl)
    U = 0.5 * np.random.default_rng(nl).standard_normal((4, 5, F, 10))
    want = np.asarray(jsig.signature_kern_tens_vs_seq(U, nl, order=1))
    got = tsig.signature_kern_tens_vs_seq(_t(U), nl).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-14)


def test_signature_kern_tens_matches_jax():
    G = np.random.default_rng(5).standard_normal((3, 4, 10))
    want = np.asarray(jsig.signature_kern_tens(G, 4))
    np.testing.assert_allclose(tsig.signature_kern_tens(_t(G), 4).numpy(),
                               want, rtol=RTOL)


def test_port_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['flax'] = None\n"
        "sys.modules['optax'] = None\n"
        "import gpsig_tpu_torch.models.svgp, gpsig_tpu_torch.models.gpr\n"
        "import gpsig_tpu_torch.convert, gpsig_tpu_torch.ops.cuda.tens_seq\n"
        "import gpsig_tpu_torch.kernels.signature\n"
        "import gpsig_tpu_torch.ops.cuda.fused_gram_ho\n"
        "import gpsig_tpu_torch.ops.cuda.tens_seq_general\n"
        "import gpsig_tpu_torch.ops.cuda.sig_gram\n"
        "import gpsig_tpu_torch.training.loop\n"
        "import gpsig_tpu_torch, gpsig_tpu_torch.ops.explicit\n"
        "import gpsig_tpu_torch.ops.low_rank, gpsig_tpu_torch.kernels.vosf\n"
        "import gpsig_tpu_torch.kernels.low_rank\n"
        "import gpsig_tpu_torch.mcmc.sample, gpsig_tpu_torch.mcmc.targets\n"
        "import gpsig_tpu_torch.parallel.chains\n"
        "import gpsig_tpu_torch.parallel.mesh, gpsig_tpu_torch.parallel.train\n"
        "import gpsig_tpu_torch.parallel.loader\n"
        "import gpsig_tpu_torch.parallel.goursat_sp\n"
        "import gpsig_tpu_torch.parallel.distributed_check\n"
        "import gpsig_tpu_torch.parallel.worker, gpsig_tpu_torch.entry\n"
        "import gpsig_tpu_torch.utils.metrics\n"
        "from gpsig_tpu_torch import compat\n"
        "import gpsig_tpu_torch.compat.inducing_variables\n"
        "import gpsig_tpu_torch.compat.kernels\n"
        "import gpsig_tpu_torch.compat.likelihoods\n"
        "import gpsig_tpu_torch.compat.models\n"
        "import gpsig_tpu_torch.compat.preprocessing\n"
        "import gpsig_tpu_torch.compat.training\n"
        "assert not any(m.startswith('jax') and sys.modules[m] is not None"
        " for m in sys.modules)\n"
        "assert not any(m.split('.')[0] in ('optax', 'flax')"
        " and sys.modules[m] is not None for m in sys.modules)\n"
        "assert not any(m == 'gpsig_tpu' or m.startswith('gpsig_tpu.')"
        " for m in sys.modules)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
