"""Port parity: ``env_scan`` (the port of the JAX package's only Pallas
kernel, ``env_kernel`` in tools/evaluate_scan_kernel_strategy.py:72-87)
against a ``lax.scan`` of the same per-sample step, and against the Pallas
kernel itself run through ``pl.pallas_call(..., interpret=True)``, as a JAX
test runs it on the CPU.

The tool's kernel and step are closures and cannot be imported, so their
bodies are copied here. On CPU the port runs the plain twin
``env_scan_plain``; the shape is the tool's time-major ``[480, B]`` at
B = 64 over 3 blocks, with the envelope carried across blocks. Tolerance:
1e-5 abs on the log envelope, 1e-6 relative on the carried envelope.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from audioforge_tpu_torch.ops.envelope import env_scan

T, B, R = 480, 64, 3


def _step(env, v):  # tools/evaluate_scan_kernel_strategy.py:57-61
    a = jnp.abs(v)
    c = jnp.where(a > env, 0.3, 0.01)
    env = c * env + (1 - c) * a
    return env, jnp.log(jnp.maximum(env, 1e-10))


def _env_kernel(x_ref, env_ref, o_ref, env_out_ref):  # tools/evaluate_scan_kernel_strategy.py:72-81
    def body(t, env):
        v = x_ref[t, :]
        a = jnp.abs(v)
        c = jnp.where(a > env, 0.3, 0.01)
        env = c * env + (1 - c) * a
        o_ref[t, :] = jnp.log(jnp.maximum(env, 1e-10))
        return env

    env_out_ref[...] = jax.lax.fori_loop(0, T, body, env_ref[...])


def _pallas_run():
    """The tool's ``pcall`` (tools/evaluate_scan_kernel_strategy.py:83-87),
    interpreted: ``(x [T, B], env [B]) -> (y [T, B], env [B])``."""
    pcall = pl.pallas_call(
        _env_kernel,
        out_shape=(jax.ShapeDtypeStruct((T, B), jnp.float32),
                   jax.ShapeDtypeStruct((B,), jnp.float32)),
        interpret=True,
    )
    return jax.jit(pcall)


def _check_blocks(run):
    """``run(env, x) -> (env, y)`` (JAX) against the port over R blocks."""
    xs = np.random.default_rng(0).standard_normal((R, T, B)).astype(np.float32)
    env_j = jnp.zeros((B,), jnp.float32)
    env_t = torch.zeros(B)
    for r in range(R):
        env_j, y_j = run(env_j, jnp.asarray(xs[r]))
        y_t, env_t = env_scan(torch.as_tensor(xs[r]), env_t)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5)
        np.testing.assert_allclose(env_t.numpy(), np.asarray(env_j), rtol=1e-6)


def test_env_scan_matches_reference_scan():
    _check_blocks(jax.jit(lambda env, x: jax.lax.scan(_step, env, x)))


def test_env_scan_matches_pallas_kernel():
    pcall = _pallas_run()

    def run(env, x):
        y, env = pcall(x, env)
        return env, y

    _check_blocks(run)
