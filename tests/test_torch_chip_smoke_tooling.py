"""The ``chip_smoke.py`` phases of the Stable Diffusion wrappers, TiledLinear,
the autotuner and the one-card tooling (``diffusers``, ``tiled_linear``,
``autotune``, ``tooling``) at a tiny size on the CPU: narrow widths, the
kernels' plain versions, the CUDA graph stood in by a capture that runs
the function where a graph would replay it. Each phase's gates and record,
and a planted fault for each failing its phase (replays that read stale
inputs, a tile grid laid out wrong, an optimal config that is not the
best measured, a profiler that drops a class of products)."""

import json

import pytest
import torch

import chip_smoke
from deepspeed_tpu_torch.models import diffusers_wrappers as dw

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each


def tiny_llama(n_layer=None):
    from deepspeed_tpu_torch.models import CausalLM, TransformerConfig
    return CausalLM(TransformerConfig(
        vocab_size=256, n_layer=n_layer or 2, n_head=4, d_model=64, d_ff=128, max_seq=64,
        pos_embedding="rope", norm="rmsnorm", activation="swiglu", tie_embeddings=False,
        norm_eps=1e-6, attention_backend="flash"))


def tiny_bert(n_layer=None, **over):
    from deepspeed_tpu_torch.models import BertConfig, BertModel
    cfg = BertConfig(vocab_size=1200, max_seq=128, n_layer=n_layer or 6, n_head=2, d_model=32,
                     d_ff=64, **over)
    return BertModel(cfg, with_mlm_head=True)


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setattr(chip_smoke, "CHECK_DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "SD_UNET", {**chip_smoke.SD_UNET, "channels": 32,
                                                "heads": 2, "groups": 8, "ff": 64, "temb": 64,
                                                "latent": 8})
    monkeypatch.setattr(chip_smoke, "SD_VAE", {**chip_smoke.SD_VAE, "enc_channels": 16,
                                               "dec_channels": 32, "groups": 8, "image": 16})
    monkeypatch.setattr(chip_smoke, "SD_STEPS", 4)
    monkeypatch.setattr(chip_smoke, "SD_PARITY_LATENT", 8)
    monkeypatch.setattr(chip_smoke, "TILED_SHAPE", (2, 16, 64, 96))
    monkeypatch.setattr(chip_smoke, "autotune_llama", tiny_llama)
    monkeypatch.setattr(chip_smoke, "tooling_llama", tiny_llama)
    monkeypatch.setattr(chip_smoke, "bert_large", tiny_bert)
    monkeypatch.setattr(chip_smoke, "AUTOTUNE_SEQ", 32)
    monkeypatch.setattr(chip_smoke, "TOOLING_BERT", (2, 4, 64))


@pytest.fixture
def graphs(monkeypatch):
    """The graph path on the CPU: a capture runs the function and keeps its
    output; a replay runs it on the static buffers and writes that output
    in place."""
    def capture(run):
        run()
        out = run()

        def replay():
            out.copy_(run())
        return replay, out
    monkeypatch.setattr(dw, "uses_graph", lambda device: device is not None)
    monkeypatch.setattr(dw, "capture_graph", capture)


def _last(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()
            if x.startswith("{")][-1]


def test_diffusers_phase(tiny, graphs, capsys):
    state = {}
    chip_smoke.phase_diffusers(state, seed=0)
    rec = _last(capsys)
    assert rec["phase"] == "diffusers"
    unet = rec["unet"]
    assert unet["captures"] == 1 and unet["replays"] == chip_smoke.SD_STEPS
    assert unet["elements_differing_per_step"] == [0] * chip_smoke.SD_STEPS
    assert rec["vae"]["encode"]["elements_differing"] == 0 == \
        rec["vae"]["decode"]["elements_differing"]
    assert rec["vae"]["replays"] == 4
    assert rec["card_vs_cpu"]["fault_ulp_err"]["kv_head_shifted"] > chip_smoke.LOGIT_ULP_TOL
    assert set(state["diffusers_launches"]) == {"flash_attention_fwd_sd", "spatial_bias_add"}


def test_diffusers_phase_fails_on_stale_replays(tiny, graphs, monkeypatch):
    monkeypatch.setattr(dw, "_copy_into", lambda static, x: None)
    with pytest.raises(RuntimeError, match="graph and eager outputs differ"):
        chip_smoke.phase_diffusers({}, seed=0)


def test_tiled_linear_phase(tiny, capsys):
    chip_smoke.phase_tiled_linear({}, seed=0)
    rec = _last(capsys)
    assert rec["phase"] == "tiled_linear"
    for lowering in ("einsum", "scan_tiles"):
        assert max(rec[lowering]["ulp_err"].values()) <= chip_smoke.TILED_ULP_TOL
        assert rec[lowering]["fault_ulp_err"]["grid_transposed"] > chip_smoke.TILED_ULP_TOL


def test_tiled_linear_phase_fails_on_a_wrong_grid(tiny, monkeypatch):
    from deepspeed_tpu_torch.runtime.zero.tiling import TiledLinear
    monkeypatch.setattr(TiledLinear, "from_dense", lambda self, w, b=None: {
        "w": w.reshape(self.out_splits, self.in_splits, self.tile_in, self.tile_out)})
    with pytest.raises(RuntimeError, match="tiled_linear failed"):
        chip_smoke.phase_tiled_linear({}, seed=0)


def test_autotune_phase(tiny, capsys):
    state = {}
    chip_smoke.phase_autotune(state, seed=0)
    rec = _last(capsys)
    assert rec["phase"] == "autotune"
    assert [t["candidate"] for t in rec["trials"]] == [
        f"z0_mbs{m}_remat-none_chunk0" for m in (1, 2, 4)]
    assert rec["winner"] == max(rec["trials"], key=lambda t: t["metric"])["candidate"]
    assert rec["optimal"]["model_overrides"] == {"remat": "none", "loss_chunk": 0}
    assert not chip_smoke.os.path.exists(chip_smoke.AUTOTUNE_DIR)


def test_autotune_phase_fails_when_the_optimum_is_not_the_best(tiny, monkeypatch):
    from deepspeed_tpu_torch.autotuning import Autotuner
    real = Autotuner.optimal_config
    monkeypatch.setattr(Autotuner, "optimal_config",
                        lambda self, cand: real(self, self.records[0].candidate))
    with pytest.raises(RuntimeError, match="not the best measured"):
        chip_smoke.phase_autotune({}, seed=0)


def test_tooling_phase(tiny, capsys):
    state = {"card": "NVIDIA H100 80GB HBM3, 700.00 W"}
    chip_smoke.phase_tooling(state, seed=0)
    rec = _last(capsys)
    assert rec["phase"] == "tooling"
    meta = rec["on_device_meta"]
    assert meta["all_meta"] and meta["shapes_equal_real_build"] and meta["layers"] == 2
    prof = rec["flops_profiler"]
    assert prof["products"] == prof["products_reckoned"]
    assert rec["report"]["rc"] == 0
    assert rec["elastic"]["engine"] == rec["elastic"]["in_process"]
    assert not chip_smoke.os.path.exists(chip_smoke.TOOLING_DIR)


def test_tooling_phase_fails_when_products_go_uncounted(tiny, monkeypatch):
    from deepspeed_tpu_torch.profiling.flops_profiler import profiler
    monkeypatch.setattr(profiler, "_PRODUCTS", ("mm", "addmm", "baddbmm"))
    with pytest.raises(RuntimeError, match="profiled products"):
        chip_smoke.phase_tooling({}, seed=0)
