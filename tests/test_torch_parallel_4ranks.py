"""The port's multi-device code at 4 gloo ranks on the CPU: the TP modules
at model 4, SP and PP at 4, the vocoder's chunks over a 4-rank model axis,
and the diffusion train step at data 2 x model 2 against JAX's step from
the same state and draws (op by op, as ``tests/test_torch_training.py``
runs it, with that file's tolerances), ``train_diffusion(mesh=)``'s
checkpoint resumed on one device, bit for bit, the GAN steps at data 2 x
model 2 (resblocks "1" and "2") against JAX's, the model axis of 4 that
TINY's 2-channel last stage refuses, and the GPipe backward at 4 stages.

One spawn for the file (``test_torch_parallel.run_ranks``)."""

import numpy as np
import pytest
import torch

from test_torch_parallel import (
    GAN_RESBLOCK2,
    case_result,
    check_gan_steps,
    check_pp_grads,
    check_train_step,
    gan_reference,
    gan_setup,
    in_port_layout,
    module_refs,
    module_setup,
    pp_grad_reference,
    pp_reference,
    pp_setup,
    small_cfg,
    sp_reference,
    spawn_in_thread,
    tiny_vocoder_params,
    train_reference,
    train_setup,
)

WORLD = 4


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    mods = module_setup()
    pp_cfg, pp_args = pp_setup()
    train = train_setup()
    cfg = small_cfg()
    _, voc_params = tiny_vocoder_params(cfg)
    mel = (0.1 * np.random.default_rng(1).standard_normal((2, 64, 100))).astype(np.float32)
    voc = dict(vcfg=cfg.vocoder, params=voc_params, mel=mel, n_chunks=4, halo=8)
    gans = {"1": gan_setup(), "2": gan_setup(GAN_RESBLOCK2)}
    cases = {
        "tp_encoder": ("case_tp_encoder", mods["enc"]),
        "tp_denoiser": ("case_tp_denoiser", mods["den"]),
        "tp_whisper": ("case_tp_whisper", mods["whisper"]),
        "sp": ("case_sp_whisper", mods["whisper"]),
        "pp": ("case_pp", pp_args),
        "vocoder": ("case_chunked_vocoder", voc),
        "train": ("case_train_step", dict(cfg=train["cfg"], data=2, jax_state=train["state0"],
                                          batch=train["batch"], t=train["t"], noise=train["noise"])),
        "resume": ("case_train_resume", dict(ckpt_dir=str(tmp_path_factory.mktemp("ckpt")))),
        **{f"gan_rb{k}": ("case_gan_steps", dict(cfg=g["cfg"], data=2, jax_state=g["jax_state"], batch=g["batch"]))
           for k, g in gans.items()},
        "gan_uneven": ("case_gan_uneven", dict(cfg=gans["1"]["cfg"])),
        "pp_grads": ("case_pp_grads", pp_args),
    }
    ranks = spawn_in_thread(WORLD, cases, tmp_path_factory.mktemp("ranks"))
    refs = module_refs(mods)
    refs["sp"] = sp_reference(mods, WORLD)
    refs["pp"] = pp_reference(pp_cfg, pp_args, WORLD)
    refs["train"] = in_port_layout(train_reference(train))
    refs["voc"] = voc
    refs["gan"] = {k: gan_reference(g) for k, g in gans.items()}
    refs["pp_grads"] = pp_grad_reference(pp_cfg, pp_args, WORLD)
    return ranks.result(), refs


def test_tp_modules_at_model_4_match_jax(run):
    """Encoder, denoiser (and its composed form) and Whisper (one head a
    rank) at a model axis of 4 against JAX's single-device modules."""
    results, refs = run
    for r in range(WORLD):
        enc, den, wsp = (case_result(results, k, r) for k in ("tp_encoder", "tp_denoiser", "tp_whisper"))
        assert (enc["table_rows"], den["conv_out"], wsp["q_rows"]) == (256 // WORLD, 128 // WORLD, 32 // WORLD)
        np.testing.assert_allclose(enc["cond"], refs["cond"], rtol=1e-5, atol=1e-5)
        assert np.abs(den["eps"] - refs["eps"]).max() < 5e-4
        assert np.abs(den["composed"] - refs["composed"]).max() < 5e-4
        np.testing.assert_allclose(wsp["feats"], refs["whisper"], rtol=2e-4, atol=2e-5)


def test_sp_whisper_at_4_matches_jax(run):
    results, refs = run
    for r in range(WORLD):
        np.testing.assert_allclose(case_result(results, "sp", r), refs["sp"], rtol=2e-4, atol=2e-5)


def test_pp_at_4_stages_matches_jax(run):
    results, refs = run
    for r in range(WORLD):
        np.testing.assert_allclose(case_result(results, "pp", r), refs["pp"], rtol=0, atol=1e-5)


def test_chunked_vocoder_over_4_ranks_equals_folded(run):
    """Each rank runs one of 4 chunks and the kept frames are all-gathered:
    the wave of the chunks folded into one batch (held to JAX's in
    test_torch_parallel.py), to f32 rounding."""
    from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import load_jax_params
    from svc_inference_pipeline_tpu_torch.models.bigvgan import BigVGANGenerator
    from svc_inference_pipeline_tpu_torch.parallel.tp_vocoder import chunked_vocoder_apply

    results, refs = run
    v = refs["voc"]
    port = load_jax_params(BigVGANGenerator(v["vcfg"]), v["params"])
    with torch.no_grad():
        folded = chunked_vocoder_apply(port, torch.from_numpy(v["mel"]), 4, v["halo"], 256).numpy()
    for r in range(WORLD):
        got = case_result(results, "vocoder", r)
        assert got.shape == folded.shape
        assert np.abs(got - folded).max() <= 1e-5 * np.abs(folded).max()


def test_train_step_data2_model2_matches_jax(run):
    results, refs = run
    for r in range(WORLD):
        got = case_result(results, "train", r)
        assert got["local_rows"] == 2 * 64 // 2
        check_train_step(got, refs["train"])


def test_train_diffusion_mesh_checkpoint_resumes_on_one_device(run):
    """The mesh run's checkpoint (gathered, written by rank 0) loads on one
    device bit for bit; resumed there to step 5 it stays within f32
    reordering of the mesh run to 5 and of a single-device run to 5."""
    results, _ = run
    got = case_result(results, "resume", 0)
    assert got["loaded_step"] == 3 and got["resumed_step"] == 5
    for k, v in got["at3"].items():
        np.testing.assert_array_equal(got["loaded"][k], v, err_msg=k)
    for other in ("whole_mesh", "single"):
        for k, v in got[other].items():
            np.testing.assert_allclose(got["resumed"][k], v, rtol=0, atol=1e-5, err_msg=f"{other} {k}")


@pytest.mark.parametrize("resblock", ["1", "2"])
def test_gan_steps_data2_model2_match_jax(run, resblock):
    """The GAN steps on a data 2 x model 2 mesh from JAX's TINY state, with
    AMPBlock1 and with AMPBlock2 (dilations [1, 3]), against JAX's steps."""
    results, refs = run
    for r in range(WORLD):
        got = case_result(results, f"gan_rb{resblock}", r)
        assert got["gen"]["local_rows"] == 32 // 2
        check_gan_steps(got, refs["gan"][resblock])


def test_gan_model_axis_must_divide_every_stage(run):
    """TINY's last stage has 2 channels: a model axis of 4 is refused by
    name before anything is sliced (GSPMD would pad; the port's shards are
    equal)."""
    results, _ = run
    for r in range(WORLD):
        msg = case_result(results, "gan_uneven", r)
        assert msg is not None and "model axis (4)" in msg and "resblock_3_0" in msg and "up_3" in msg, msg


def test_pp_gradients_at_4_stages_match_jax(run):
    results, refs = run
    check_pp_grads(results, refs["pp_grads"], WORLD)
