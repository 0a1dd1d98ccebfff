"""The port's §III ptychography (simulation and RAAR solver) against the
reference, on the CPU: the same problem goes through the JAX package and
the port (converted with ``repro_torch.apps.ptycho.convert``), and the
assertions of ``tests/test_apps.py`` are repeated on the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps.ptycho import sim as jsim
from repro.apps.ptycho import solver as jsolver
from repro_torch.apps.ptycho.convert import (problem_from_numpy,
                                             waves_from_numpy)
from repro_torch.apps.ptycho.sim import (gather_patches, scatter_add_patches,
                                         simulate)
from repro_torch.apps.ptycho.solver import (SolverConfig, init_waves,
                                            overlap_update, raar_step,
                                            reconstruct,
                                            reconstruction_quality)


def test_torch_simulate_matches_jax():
    """Object, probe and positions come from numpy in both packages; the
    magnitudes differ only by FFT round-off."""
    ours = simulate(obj_size=96, probe_size=32, step=8, device="cpu")
    ref = jsim.simulate(obj_size=96, probe_size=32, step=8)
    np.testing.assert_array_equal(ours.positions, ref.positions)
    np.testing.assert_array_equal(ours.object_true.numpy(),
                                  np.asarray(ref.object_true))
    np.testing.assert_array_equal(ours.probe_true.numpy(),
                                  np.asarray(ref.probe_true))
    want = np.asarray(ref.magnitudes)
    assert ours.magnitudes.dtype == torch.float32
    np.testing.assert_allclose(ours.magnitudes.numpy(), want, rtol=1e-5,
                               atol=1e-5 * want.max())
    np.testing.assert_array_equal(ours.magnitudes_host,
                                  ours.magnitudes.numpy())


def test_torch_simulate_with_photon_noise_matches_jax():
    ours = simulate(obj_size=64, probe_size=16, step=8, photons=1e4,
                    device="cpu")
    ref = jsim.simulate(obj_size=64, probe_size=16, step=8, photons=1e4)
    # The Poisson draws come from the same numpy stream, but a rate that
    # differs by round-off can take another rejection path and shift the
    # stream, so compare the noisy intensities in bulk.
    got = ours.magnitudes.numpy() ** 2
    want = np.asarray(ref.magnitudes) ** 2
    assert got.dtype == np.float32
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=1e-2)
    np.testing.assert_allclose(got.std(), want.std(), rtol=1e-2)


def test_torch_gather_scatter_adjoint():
    """<scatter(x), y> == <x, gather(y)> — the adjoint pair used by eqs 4-5."""
    rng = np.random.default_rng(0)
    obj = torch.from_numpy(rng.standard_normal((16, 16)).astype(np.float32))
    pos = np.array([[0, 0], [4, 7], [9, 9]], np.int32)
    x = torch.from_numpy(rng.standard_normal((3, 6, 6)).astype(np.float32))
    canvas = torch.zeros((16, 16))
    scat = scatter_add_patches(canvas, pos, x)
    assert not canvas.any()                     # the canvas is left as it was
    gath = gather_patches(obj, pos, 6)
    np.testing.assert_allclose(float(torch.sum(scat * obj)),
                               float(torch.sum(x * gath)), rtol=1e-5)
    # and the scatter agrees with the reference's
    want = jsim.scatter_add_patches(jnp.zeros((16, 16)), pos,
                                    jnp.asarray(x.numpy()))
    np.testing.assert_allclose(scat.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_torch_overlap_update_recovers_object_from_true_waves():
    """Given the TRUE exit waves, eq. (4) recovers the object on the scanned
    region (up to probe coverage)."""
    prob = simulate(obj_size=64, probe_size=24, step=6, device="cpu")
    patches = gather_patches(prob.object_true, prob.positions, 24)
    psi_true = prob.probe_true[None] * patches
    obj, probe = overlap_update(psi_true, prob.positions, prob.probe_true,
                                (64, 64), update_probe=False)
    assert probe is prob.probe_true
    m = 16
    np.testing.assert_allclose(np.abs(obj.numpy()[m:-m, m:-m]),
                               np.abs(prob.object_true.numpy()[m:-m, m:-m]),
                               rtol=0.1, atol=0.1)


def _converted_problem(obj_size, probe_size, step):
    ref = jsim.simulate(obj_size=obj_size, probe_size=probe_size, step=step)
    ours = problem_from_numpy(np.asarray(ref.object_true),
                              np.asarray(ref.probe_true), ref.positions,
                              np.asarray(ref.magnitudes), device="cpu")
    return ref, ours


@pytest.mark.parametrize("iteration", [0, 5])
def test_torch_raar_step_matches_jax(iteration):
    """One RAAR step of the port == the reference's, on the same converted
    inputs, within the 2e-4 of tests/test_apps.py. Iteration 0 updates the
    object only, iteration 5 the probe too."""
    ref, ours = _converted_problem(48, 16, 6)
    psi_j = jsolver.init_waves(ref.magnitudes, ref.probe_true)
    want = jsolver.raar_step(psi_j, ref.magnitudes,
                             jnp.asarray(ref.positions), ref.probe_true,
                             (48, 48), jsolver.SolverConfig(use_pallas=False),
                             iteration)
    psi, probe = waves_from_numpy(np.asarray(psi_j),
                                  np.asarray(ref.probe_true), device="cpu")
    np.testing.assert_allclose(init_waves(ours.magnitudes, probe).numpy(),
                               np.asarray(psi_j), rtol=1e-6, atol=1e-6)
    got = raar_step(psi, ours.magnitudes, ours.positions, probe, (48, 48),
                    SolverConfig(), iteration)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=2e-4, atol=2e-4)
    if iteration == 0:
        assert got[2] is probe                  # object-only update


def test_torch_raar_step_with_kernels_on_cpu_raises():
    """Asking for the CUDA kernels on CPU tensors fails; there is no silent
    fallback to the plain versions."""
    prob = simulate(obj_size=48, probe_size=16, step=6, device="cpu")
    psi = init_waves(prob.magnitudes, prob.probe_true)
    with pytest.raises(ValueError, match="CUDA tensor"):
        raar_step(psi, prob.magnitudes, prob.positions, prob.probe_true,
                  (48, 48), SolverConfig(use_cuda_kernels=True), 5)


def test_torch_reconstruct_converges_like_jax():
    """tests/test_apps.py's convergence test on the port, and the port's
    quality within 0.02 of the reference's from the same start."""
    ref, ours = _converted_problem(96, 32, 8)
    out = reconstruct(ours, SolverConfig(iterations=50))
    errs = out["errors"].numpy()
    assert errs.shape == (50,)
    assert errs[-1] < 0.35 * errs[0]
    q = reconstruction_quality(out["object"], ours.object_true, margin=16)
    assert q > 0.9, q
    jout = jsolver.reconstruct(
        ref, jsolver.SolverConfig(iterations=50, use_pallas=False))
    jax.block_until_ready(jout["object"])
    q_ref = jsolver.reconstruction_quality(jout["object"], ref.object_true,
                                           margin=16)
    assert abs(q - q_ref) < 0.02, (q, q_ref)
    np.testing.assert_allclose(errs[0], float(jout["errors"][0]), rtol=1e-4)
