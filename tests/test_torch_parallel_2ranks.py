"""The port's multi-device routes at 2 gloo ranks on the CPU, against JAX
(its single-device modules, which its TP equals, and its SP and GPipe code
on virtual devices) and against the port on one device.

One spawn for the file (``test_torch_parallel.run_ranks``): the ranks run
every case, JAX's side is computed meanwhile, and each case is its own
test. Tolerances: TP modules f32 within 5e-4 (the denoiser, PARITY.md
§2.7) and rtol 2e-4 (Whisper), SP rtol 2e-4 / atol 2e-5 and PP atol 1e-5
(JAX's own tests), DP bit for bit against each rank's slice on one device,
the train step on the model axis with ``tests/test_torch_training.py``'s
tolerances against the port's step on one device, the GAN steps at data 2
and at model 2 against JAX's with ``tests/test_torch_gan.py``'s, and the
GPipe backward at 2 stages against JAX's ``jax.grad`` (1e-3) and the
port's single-device autograd (1e-5), relative L2 per leaf."""

import numpy as np
import pytest

from test_torch_parallel import (
    case_result,
    check_gan_steps,
    check_pp_grads,
    check_train_step,
    gan_reference,
    gan_setup,
    module_refs,
    module_setup,
    pp_grad_reference,
    pp_reference,
    pp_setup,
    single_device_step,
    sp_reference,
    spawn_in_thread,
    train_setup,
)

WORLD = 2


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every case on 2 ranks, and JAX's references."""
    mods = module_setup()
    pp_cfg, pp_args = pp_setup()
    train = train_setup()
    gan = gan_setup()
    gan_args = dict(cfg=gan["cfg"], jax_state=gan["jax_state"], batch=gan["batch"])
    cases = {
        "tp_encoder": ("case_tp_encoder", mods["enc"]),
        "tp_denoiser": ("case_tp_denoiser", mods["den"]),
        "tp_whisper": ("case_tp_whisper", mods["whisper"]),
        "sp": ("case_sp_whisper", mods["whisper"]),
        "pp": ("case_pp", pp_args),
        "dp_plms": ("case_dp_convert", dict(sampler="plms", speedup=2)),
        "dp_ddpm_int8": ("case_dp_convert", dict(sampler="ddpm", speedup=1, quantize="int8")),
        "routes": ("case_pipeline_routes", {}),
        "train": ("case_train_step", dict(cfg=train["cfg"], data=1, jax_state=train["state0"],
                                          batch=train["batch"], t=train["t"], noise=train["noise"])),
        "gan_data": ("case_gan_steps", dict(data=WORLD, **gan_args)),
        "gan_model": ("case_gan_steps", dict(data=1, **gan_args)),
        "pp_grads": ("case_pp_grads", pp_args),
    }
    ranks = spawn_in_thread(WORLD, cases, tmp_path_factory.mktemp("ranks"))
    refs = module_refs(mods)
    refs["sp"] = sp_reference(mods, WORLD)
    refs["pp"] = pp_reference(pp_cfg, pp_args, WORLD)
    refs["train"] = single_device_step(train)
    refs["gan"] = gan_reference(gan)
    refs["pp_grads"] = pp_grad_reference(pp_cfg, pp_args, WORLD)
    return ranks.result(), refs


def test_tp_encoder_matches_jax(run):
    """Vocabulary-sharded tables and a column-sharded content projection:
    JAX's single-device encoder to 1e-5 (a sum with zeros and a gather)."""
    results, refs = run
    for r in range(WORLD):
        got = case_result(results, "tp_encoder", r)
        assert got["table_rows"] == 256 // WORLD
        np.testing.assert_allclose(got["cond"], refs["cond"], rtol=1e-5, atol=1e-5)


def test_tp_denoiser_matches_jax(run):
    """The column -> row denoiser (one all-reduce a block) and its composed
    (hoisted) form against JAX's module and ``make_fast_denoise_fn``."""
    results, refs = run
    for r in range(WORLD):
        got = case_result(results, "tp_denoiser", r)
        assert got["conv_out"] == 2 * 64 // WORLD
        assert np.abs(got["eps"] - refs["eps"]).max() < 5e-4
        assert np.abs(got["composed"] - refs["composed"]).max() < 5e-4


def test_tp_whisper_matches_jax(run):
    """Head-sharded attention (K4's plain version on 2 of 4 heads a rank),
    row-sharded out projection and MLP."""
    results, refs = run
    for r in range(WORLD):
        got = case_result(results, "tp_whisper", r)
        assert got["q_rows"] == 32 // WORLD
        np.testing.assert_allclose(got["feats"], refs["whisper"], rtol=2e-4, atol=2e-5)


def test_sp_whisper_matches_jax(run):
    results, refs = run
    for r in range(WORLD):
        np.testing.assert_allclose(case_result(results, "sp", r), refs["sp"], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(refs["sp"], refs["whisper"], rtol=2e-4, atol=2e-5)


def test_pp_matches_jax(run):
    results, refs = run
    for r in range(WORLD):
        got = case_result(results, "pp", r)
        assert got.shape == refs["pp"].shape
        np.testing.assert_allclose(got, refs["pp"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", ["dp_plms", "dp_ddpm_int8"])
def test_dp_convert_batch_equals_each_slice_alone(run, case):
    """Each data rank's two clips equal a single-device ``convert_batch`` of
    them with that rank's generator, bit for bit, and every rank holds the
    whole batch; a batch of 3 (not divisible) converts whole on every rank."""
    results, _ = run
    got = [case_result(results, case, r) for r in range(WORLD)]
    for r, res in enumerate(got):
        for j, i in enumerate(res["mine"]):
            np.testing.assert_array_equal(res["waves"][i], res["ref"][j])
        for i in range(4):
            np.testing.assert_array_equal(res["waves"][i], got[0]["waves"][i])
        assert len(res["odd"]) == 3 and all(np.isfinite(w).all() for w in res["odd"])
        for i in range(3):
            np.testing.assert_array_equal(res["odd"][i], got[0]["odd"][i])
    assert not np.array_equal(got[0]["waves"][0][:1000], got[0]["waves"][2][:1000])


def test_pipeline_tp_sp_pp_match_one_device(run):
    """A PLMS conversion (f32) of a 3 s clip with TP (the mapper, Whisper and
    the vocoder chunked over the model axis), SP Whisper and 2 GPipe stages
    against one device."""
    results, _ = run
    for r in range(WORLD):
        got = case_result(results, "routes", r)
        assert got["voc_chunked"]
        wave, mel = got["single"]
        for route in ("tp", "sp", "pp"):
            w, m = got[route]
            assert w.shape == wave.shape
            np.testing.assert_allclose(m, mel, rtol=0, atol=1e-4 * np.abs(mel).max())
            assert np.corrcoef(w, wave)[0, 1] >= 0.9999, route


def test_quantize_refused_under_tp_and_pp(run):
    results, _ = run
    errors = case_result(results, "routes")["errors"]
    for name in ("quantize_tp", "quantize_pp"):
        assert errors[name] is not None and "denoiser_quantize is set but the selected denoiser path" in errors[name]


def test_train_step_on_model_axis_matches_one_device(run):
    """One step at data 1 x model 2 from a JAX state and draws, against the
    port's step on one device (held to JAX's in tests/test_torch_training.py;
    data 2 x model 2 is held to JAX's step in test_torch_parallel_4ranks.py)."""
    results, refs = run
    for r in range(WORLD):
        got = case_result(results, "train", r)
        assert got["local_rows"] == 2 * 64 // WORLD
        check_train_step(got, refs["train"])


@pytest.mark.parametrize("case", ["gan_data", "gan_model"])
def test_gan_steps_on_a_mesh_match_jax(run, case):
    """One discriminator step and one generator step from JAX's TINY state
    at data 2 (each rank one clip of the batch) and at model 2 (the
    generator's channels split), every rank against JAX's steps."""
    results, refs = run
    for r in range(WORLD):
        got = case_result(results, case, r)
        assert got["gen"]["local_rows"] == 32 // (WORLD if case == "gan_model" else 1)
        check_gan_steps(got, refs["gan"])


def test_pp_gradients_match_jax(run):
    """jax.grad through the 2-stage GPipe (the loss of JAX's
    test_pp_gradients_flow): every leaf, the residual layers finite and
    non-zero, each rank's backward on its own stage's layers."""
    results, refs = run
    check_pp_grads(results, refs["pp_grads"], WORLD)
