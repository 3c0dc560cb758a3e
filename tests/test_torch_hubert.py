"""The port's HuBERT/ContentVec (``models/hubert.py``,
``checkpoints/hubert_convert.py``, ``ContentVecExtractor``) and the numpy
remap functions against the JAX package's, at the reduced config of
tests/test_hubert_parity.py (96 wide, 3 layers, conv 48): converted trees
equal, layer-2 hidden states and ``final_proj`` outputs within 1e-4 x
max|JAX| on the same weights, ``extract`` likewise, the remap functions
equal (the tolerance error too)."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from svc_inference_pipeline_tpu.checkpoints import hubert_convert as JC
from svc_inference_pipeline_tpu.models.hubert import HubertConfig as JaxConfig
from svc_inference_pipeline_tpu.models.hubert import HubertModel as JaxHubert
from svc_inference_pipeline_tpu.ops import remap as jremap
from svc_inference_pipeline_tpu.pipeline.content import ContentVecExtractor as JaxContentVec
from svc_inference_pipeline_tpu_torch.checkpoints import hubert_convert as PC
from svc_inference_pipeline_tpu_torch.checkpoints.from_jax import load_jax_params, random_init_
from svc_inference_pipeline_tpu_torch.models.hubert import HubertConfig, HubertModel
from svc_inference_pipeline_tpu_torch.ops import remap
from svc_inference_pipeline_tpu_torch.pipeline.content import ContentVecExtractor

transformers = pytest.importorskip("transformers")

REL_TOL = 1e-4  # of max|JAX|: f32 on both sides, convs and matmuls summed in another order


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in several
    worker processes at once, and PyTorch's thread pools, each as wide as the
    machine, slow one another down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SMALL = dict(conv_layers=tuple((48, k, s) for k, s in zip([10, 3, 3, 3, 3, 2, 2], [5, 2, 2, 2, 2, 2, 2])),
             encoder_dim=96, encoder_layers=3, encoder_heads=4, encoder_ffn_dim=192, final_dim=32)


@pytest.fixture(scope="module")
def small():
    """A reduced transformers HuBERT renamed to the fairseq layout (its
    positional conv a weight-norm pair), with a random ``final_proj`` and
    random LayerNorm/GroupNorm vectors added as ContentVec's files have
    them, and both packages' configs."""
    hf_cfg = transformers.HubertConfig(
        hidden_size=96, num_hidden_layers=3, num_attention_heads=4, intermediate_size=192,
        conv_dim=[48] * 7, conv_kernel=[10, 3, 3, 3, 3, 2, 2], conv_stride=[5, 2, 2, 2, 2, 2, 2],
        feat_extract_norm="group", do_stable_layer_norm=False, feat_proj_dropout=0.0, hidden_dropout=0.0,
        attention_dropout=0.0, activation_dropout=0.0, layerdrop=0.0, num_conv_pos_embeddings=128,
        num_conv_pos_embedding_groups=16,
    )
    torch.manual_seed(0)
    hf = transformers.HubertModel(hf_cfg).eval()
    rng = np.random.default_rng(0)
    plain = JC.transformers_to_fairseq_keys({k: v.detach().numpy() for k, v in hf.state_dict().items()})
    sd = dict(plain)
    for k in list(sd):
        if k.endswith(("norm.weight", "norm.bias", ".2.weight", ".2.bias")):
            sd[k] = (sd[k] + 0.1 * rng.standard_normal(sd[k].shape)).astype(np.float32)
    sd["final_proj.weight"] = (rng.standard_normal((32, 96)) / np.sqrt(96)).astype(np.float32)
    sd["final_proj.bias"] = (0.1 * rng.standard_normal(32)).astype(np.float32)
    return dict(hf=hf, sd=sd, plain=plain, jcfg=JaxConfig(**SMALL), pcfg=HubertConfig(**SMALL))


def _assert_trees_equal(a, b, path=""):
    assert set(a) == set(b), path
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
        else:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, f"{path}/{k}"
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=f"{path}/{k}")


def _close(got, want):
    assert got.shape == want.shape
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= REL_TOL * scale, (err, scale)


def test_key_renames_and_conversion_equal_jax(small):
    hf_sd = {k: v.detach().numpy() for k, v in small["hf"].state_dict().items()}
    renamed = PC.transformers_to_fairseq_keys(hf_sd)
    assert renamed.keys() == JC.transformers_to_fairseq_keys(hf_sd).keys()
    assert {"encoder.pos_conv.0.weight_g", "encoder.pos_conv.0.weight_v"} <= set(renamed)
    _assert_trees_equal(PC.convert_hubert_state_dict(small["sd"], small["pcfg"]),
                        JC.convert_hubert_state_dict(small["sd"], small["jcfg"]))


@pytest.mark.parametrize("final_proj", [False, True])
def test_layer_outputs_match_jax(small, final_proj):
    """Layer 2's hidden states, and the same through ``final_proj``."""
    params = JC.convert_hubert_state_dict(small["sd"], small["jcfg"])
    wav = (0.1 * np.random.default_rng(0).standard_normal((1, 8000))).astype(np.float32)
    want = np.asarray(JaxHubert(small["jcfg"]).apply({"params": params}, wav, output_layer=2,
                                                      final_proj=final_proj))
    model = load_jax_params(HubertModel(small["pcfg"]), params).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(wav), output_layer=2, final_proj=final_proj).numpy()
    assert got.shape == want.shape == (1, 24, 32 if final_proj else 96)
    _close(got, want)


def test_transformers_weights_give_transformers_hidden_states(small):
    """The unaltered transformers weights through the port's converter and
    model give transformers' own layer-2 hidden states, within the JAX
    suite's bound (tests/test_hubert_parity.py)."""
    cfg = small["pcfg"]
    params = PC.convert_hubert_state_dict(small["plain"], cfg)
    params["final_proj"] = {"kernel": np.zeros((96, 32), np.float32), "bias": np.zeros(32, np.float32)}
    model = load_jax_params(HubertModel(cfg), params).eval()
    wav = (0.1 * np.random.default_rng(0).standard_normal((1, 8000))).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(wav), output_layer=2, final_proj=False).numpy()
        hf = small["hf"](torch.from_numpy(wav), output_hidden_states=True).hidden_states[2].numpy()
    assert np.abs(got - hf).max() < 2e-3


def test_jax_init_tree_loads_strictly(small):
    """JAX's ``model.init`` tree loads completely (GroupNorm scale, the
    grouped positional conv); a missing leaf raises."""
    jmodel = JaxHubert(small["jcfg"])
    wav = (0.1 * np.random.default_rng(1).standard_normal((1, 4000))).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0), jnp.asarray(wav), output_layer=3,
                                                            final_proj=True)["params"])
    model = load_jax_params(HubertModel(small["pcfg"]), params).eval()
    want = np.asarray(jmodel.apply({"params": params}, wav, output_layer=3))
    with torch.no_grad():
        _close(model(torch.from_numpy(wav), output_layer=3).numpy(), want)
    assert model.pos_conv.weight.shape == (96, 96 // 16, 128)
    del params["feature_extractor"]["group_norm"]["scale"]
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(HubertModel(small["pcfg"]), params)


def test_random_init_keeps_norm_scales():
    cfg = HubertConfig(**SMALL)
    model = random_init_(HubertModel(cfg), torch.Generator().manual_seed(0))
    assert (model.feature_extractor.group_norm.weight == 1).all()
    assert (model.layer_0.final_layer_norm.weight == 1).all()
    with torch.no_grad():
        out = model(0.1 * torch.randn(1, 8000, generator=torch.Generator().manual_seed(1)), output_layer=3)
    assert out.std() > 1e-3  # the features do not collapse


def _write_fairseq(small, tmp_path):
    path = tmp_path / "contentvec.pt"
    torch.save({"args": argparse.Namespace(arch="hubert", encoder_layers=3),
                "model": {k: torch.from_numpy(np.asarray(v)) for k, v in small["sd"].items()}}, path)
    return str(path)


def test_load_hubert_equals_jax(small, tmp_path, monkeypatch):
    """A fairseq-layout file (``args`` pickled beside ``model``), read by both
    packages at the reduced config."""
    path = _write_fairseq(small, tmp_path)
    monkeypatch.setattr(PC, "HubertConfig", lambda: small["pcfg"])
    monkeypatch.setattr(JC, "HubertConfig", lambda: small["jcfg"])
    pcfg, ptree = PC.load_hubert(path)
    jcfg, jtree = JC.load_hubert(path)
    assert pcfg == small["pcfg"]
    _assert_trees_equal(ptree, jtree)


def test_contentvec_extract_matches_jax(small, tmp_path, monkeypatch):
    """``extract`` from the same file: 1.1 s at 24 kHz -> [mel_len, 32]."""
    path = _write_fairseq(small, tmp_path)
    monkeypatch.setattr(PC, "HubertConfig", lambda: small["pcfg"])
    monkeypatch.setattr(JC, "HubertConfig", lambda: small["jcfg"])
    t = np.arange(26400) / 24000
    audio = (0.3 * np.sin(2 * np.pi * 220 * t) + 0.02 * np.random.default_rng(2).standard_normal(len(t)))
    audio = audio.astype(np.float32)
    mel_len = len(audio) // 256
    ours = ContentVecExtractor.from_torch_checkpoint(path, device="cpu", output_layer=2)
    jcfg, jparams = JC.load_hubert(path)
    theirs = JaxContentVec(jparams, cfg=jcfg, output_layer=2)
    got, want = ours.extract(audio, mel_len), np.asarray(theirs.extract(audio, mel_len))
    assert got.shape == want.shape == (mel_len, 32) and got.dtype == np.float32
    _close(got, want)
    rand = ContentVecExtractor.random_init(small["pcfg"], generator=torch.Generator().manual_seed(0),
                                           device="cpu", output_layer=3)
    feats = rand.extract(audio, mel_len)
    assert feats.shape == (mel_len, 32) and np.isfinite(feats).all()


@pytest.mark.parametrize("target_len,fast,cap", [(1, True, 1500), (99, True, 1500), (2900, True, 1500),
                                                 (60, False, None), (3000, True, None)])
def test_remap_features_equals_jax(target_len, fast, cap):
    feats = np.random.default_rng(4).standard_normal((1600, 8)).astype(np.float32)
    got = remap.remap_features(feats, target_len, fast_mapping=fast, max_source_len=cap)
    want = jremap.remap_features(feats, target_len, fast_mapping=fast, max_source_len=cap)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("source_len,target_len", [(50, 93), (50, 95), (50, 90), (50, 97), (50, 89), (7, 13)])
def test_remap_tolerant_equals_jax(source_len, target_len):
    """50 source frames give 93 mel frames: within +-3 the result is cut or
    padded with the last frame; beyond, both raise."""
    feats = np.random.default_rng(5).standard_normal((source_len, 6)).astype(np.float32)
    try:
        want = jremap.remap_features_tolerant(feats, target_len)
    except ValueError:
        with pytest.raises(ValueError, match="beyond tolerance"):
            remap.remap_features_tolerant(feats, target_len)
        assert abs(target_len - source_len * 15 // 8) > 3
        return
    got = remap.remap_features_tolerant(feats, target_len)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src,target", [(5, 5), (5, 12), (12, 5), (1, 4)])
def test_repeat_expand_2d_equals_jax(src, target):
    content = np.random.default_rng(6).standard_normal((3, src)).astype(np.float32)
    np.testing.assert_array_equal(remap.repeat_expand_2d(content, target), jremap.repeat_expand_2d(content, target))


def test_exported_fairseq_file_loads_back(small, tmp_path, monkeypatch):
    """chip_smoke's exporter (``module_tree`` -> ``hubert_checkpoint``, the
    positional conv as a weight-norm pair over dim 2) read back through
    ``ContentVecExtractor.from_torch_checkpoint``: every parameter equals the
    drawn one, the folded positional conv within one f32 ulp of the file's
    g v / |v| in float64 (and within two of the drawn weight)."""
    cfg = small["pcfg"]
    drawn = random_init_(HubertModel(cfg), torch.Generator().manual_seed(3))
    path = tmp_path / "exported.pt"
    ckpt = chip_smoke.hubert_checkpoint(chip_smoke.module_tree(drawn), cfg, np.random.default_rng(0))
    torch.save(ckpt, path)
    monkeypatch.setattr(PC, "HubertConfig", lambda: cfg)
    loaded = ContentVecExtractor.from_torch_checkpoint(str(path), device="cpu").model
    want = dict(drawn.named_parameters())
    g, v = (ckpt["model"][f"encoder.pos_conv.0.weight_{k}"].double().numpy() for k in "gv")
    fold = (g * v / np.sqrt(np.sum(v * v, axis=(0, 1), keepdims=True))).astype(np.float32)
    for name, p in loaded.named_parameters():
        if name == "pos_conv.weight":  # the file's g v / |v| in float64, rounded to f32: within one ulp
            assert (np.abs(p.detach().numpy() - fold) <= np.spacing(np.abs(fold))).all()
            # and the drawn weight again, within the rounding of g and v to f32
            w = want[name].detach().numpy()
            assert (np.abs(p.detach().numpy() - w) <= 2 * np.spacing(np.abs(w))).all()
        else:
            assert torch.equal(p.detach(), want[name].detach()), name
    assert len(dict(loaded.named_parameters())) == len(want)
