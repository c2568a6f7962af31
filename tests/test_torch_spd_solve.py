"""The port's batched SPD solve against the JAX package's.

The plain version (the CPU path of the wrapper) against the Pallas kernel in
interpret mode and against the f64 Cholesky fallback, and the wrapper's
routing and input checks. The CUDA kernel itself is held against the plain
version in tests/test_torch_card.py and chip_smoke.py.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_quadruped_tpu_torch.ops import spd_solve as port

ref = importlib.import_module('gym_quadruped_tpu.ops.spd_solve')


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    # tiny batched products are slower on many threads of a shared CPU
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_spd(rng, B, n, dtype=np.float32):
    A = rng.randn(B, n, n).astype(dtype)
    A = A @ np.swapaxes(A, 1, 2) + n * np.eye(n, dtype=dtype)
    b = rng.randn(B, n).astype(dtype)
    return A, b


@pytest.mark.parametrize('B,n', [(64, 18), (100, 7)])
def test_plain_f32_matches_pallas_interpret(B, n):
    A, b = _random_spd(np.random.RandomState(B + n), B, n)
    ref.INTERPRET = True
    try:
        x_ref = np.asarray(ref.spd_solve_batched(jnp.asarray(A), jnp.asarray(b)))
    finally:
        ref.INTERPRET = False
    x = port.spd_solve_batched(torch.as_tensor(A), torch.as_tensor(b)).numpy()
    assert x.dtype == np.float32
    # the relative bar of tests/test_spd_solve.py: both run the same f32
    # algorithm, so only the rounding of the back substitution's order differs
    err = np.abs(x - x_ref).max() / (1 + np.abs(x_ref).max())
    assert err < 1e-4, err


def test_plain_f64_matches_cholesky_fallback():
    A, b = _random_spd(np.random.RandomState(1), 32, 18, np.float64)
    x_ref = np.asarray(jax.jit(jax.vmap(ref.spd_solve))(jnp.asarray(A), jnp.asarray(b)))
    x = port.spd_solve_batched(torch.as_tensor(A), torch.as_tensor(b)).numpy()
    # f64: the unrolled algorithm and cho_solve agree to rounding (~1e-15)
    np.testing.assert_allclose(x, x_ref, rtol=0, atol=1e-9)


def test_wrapper_routes_cpu_to_plain_and_counts_no_launch():
    A, b = _random_spd(np.random.RandomState(2), 5, 18)
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    before = port.launches
    x = port.spd_solve_batched(At, bt)
    assert port.launches == before
    assert torch.equal(x, port.unrolled_chol_solve_torch(At, bt))
    x1 = port.spd_solve(At[0], bt[0])
    assert torch.equal(x1, port.unrolled_chol_solve_torch(At[:1], bt[:1])[0])


def test_wrapper_raises_on_bad_rank():
    A = torch.eye(4).expand(2, 4, 4)
    with pytest.raises(ValueError, match='expected A'):
        port.spd_solve_batched(A[0], torch.ones(2, 4))
    with pytest.raises(ValueError, match='expected A'):
        port.spd_solve_batched(A, torch.ones(2, 4, 1))
    with pytest.raises(ValueError, match='expected A'):
        port.spd_solve_batched(A, torch.ones(2, 3))
    with pytest.raises(ValueError, match='expected A'):
        port.spd_solve(A, torch.ones(2, 4))


@pytest.mark.parametrize('case,match', [
    ('f64', 'float32'), ('n33', 'n <= 32'), ('strided', 'contiguous'),
    ('meta', 'CUDA tensors')])
def test_kernel_path_raises_on_inputs_it_does_not_take(case, match):
    # A tensor off the CPU takes the kernel path, which checks its inputs
    # before it builds or launches anything: meta tensors reach it here.
    n = 33 if case == 'n33' else 18
    dtype = torch.float64 if case == 'f64' else torch.float32
    A = torch.empty(8, n, n, dtype=dtype, device='meta')
    b = torch.empty(8, n, dtype=dtype, device='meta')
    if case == 'strided':
        A = A.transpose(1, 2)
    with pytest.raises(ValueError, match=match):
        port.spd_solve_batched(A, b)
