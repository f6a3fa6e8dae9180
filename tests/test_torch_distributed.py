"""The port's multi-process worker (``python -m
gpsig_tpu_torch.parallel.worker``) against the JAX package's sharded run.

Two worker processes join a gloo process group (a ``file://`` store) and
run ``distributed_check``'s problem for 4 sharded natgrad + Adam steps in
float64, with the JAX model's leaves carried across in an ``.npz``; their
ELBO and checksum must equal JAX's ``run_steps`` on a 2-device mesh at
rtol 1e-10, and each other bitwise (the JAX twin:
``tests/test_distributed.py``).
"""

import json
import os
import subprocess
import sys

import numpy as np

import jax

from gpsig_tpu.parallel import distributed_check as jdc
from gpsig_tpu.parallel import mesh as jmesh
from gpsig_tpu_torch.parallel import distributed_check as tdc

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
ITERS = 4


def leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(k.name for k in path): np.asarray(v) for path, v in flat}


def test_two_rank_worker_matches_jax_run_steps(tmp_path):
    model, _, _ = jdc.build_problem()
    arrays = tmp_path / "leaves.npz"
    np.savez(arrays, **leaves(model))
    store = tmp_path / "store"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "gpsig_tpu_torch.parallel.worker",
         "--init-method", f"file://{store}", "--world-size", "2",
         "--rank", str(rank), "--backend", "gloo", "--device", "cpu",
         "--iters", str(ITERS), "--arrays", str(arrays)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        env=env) for rank in (0, 1)]
    try:
        # JAX's run while the workers run
        mesh = jmesh.make_mesh(data=2, tile=1, devices=jax.devices()[:2])
        elbo, checksum = jdc.run_steps(mesh, num_iters=ITERS)
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [o["rank"] for o in outs] == [0, 1]
    assert all(o["world_size"] == 2 for o in outs)
    # replicated results: bitwise equal across the ranks
    assert outs[0]["elbo"] == outs[1]["elbo"]
    assert outs[0]["checksum"] == outs[1]["checksum"]
    # on the CPU the plain versions run: no kernel launched
    assert not any(outs[0]["launches"].values())
    np.testing.assert_allclose(outs[0]["elbo"], elbo, rtol=1e-10)
    np.testing.assert_allclose(outs[0]["checksum"], checksum, rtol=1e-10)


def test_problem_matches_jax_and_draws_its_own_inducing_tensors():
    """X and Y are the JAX problem's bitwise; without the JAX leaves the
    inducing tensors come from the port's own generator."""
    jm, jX, jY = jdc.build_problem()
    tm, tX, tY = tdc.build_problem(device="cpu")
    np.testing.assert_array_equal(tX.numpy(), np.asarray(jX))
    np.testing.assert_array_equal(tY.numpy(), np.asarray(jY))
    assert tm.inducing.raw_Z.shape == jm.inducing.raw_Z.shape
    loaded, _, _ = tdc.build_problem(leaves(jm), device="cpu")
    np.testing.assert_array_equal(loaded.inducing.raw_Z.detach().numpy(),
                                  np.asarray(jm.inducing.raw_Z))
