"""The port's golden tools (``biogpt_tpu_torch/tools/make_goldens.py``,
``check_goldens_gpu.py``) against the JAX package's ``make_goldens``, on
the CPU at a tiny configuration with BioGPT's full vocabulary (so the
golden prompt's ids are in range):

- the recipe's constants are JAX's;
- ``--quant`` gives the ids of JAX's ``make_quant_goldens`` run at the
  same configuration;
- the HF mode writes a file whose greedy ids the port's f32 engine
  replays;
- ``check_goldens_gpu`` exits 2 without a card or a golden;
- the committed ``gpu347m_seed7_bf16.npz`` holds the recipe's keys,
  prompt and 24 ids a format, written on an NVIDIA card.
"""

import os

import numpy as np
import torch

import biogpt_tpu.config as jax_config
from biogpt_tpu.config import BioGptConfig as JaxConfig
from biogpt_tpu.tools import make_goldens as jax_goldens

from biogpt_tpu_torch.config import BioGptConfig, GenerationParams
from biogpt_tpu_torch.modelio.checkpoint import params_from_state_dict
from biogpt_tpu_torch.runtime.engine import Engine
from biogpt_tpu_torch.tools import check_goldens_gpu, make_goldens

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
KW = dict(d_model=64, d_ff=128, n_head=4, n_layer=2, n_vocab=42384,
          n_positions=64)


def test_constants_equal_jax():
    for name in ("SEED", "SCALE", "PROMPT", "N_NEW", "N_NEW_Q", "QTYPES"):
        assert getattr(make_goldens, name) == getattr(jax_goldens, name), name


def test_quant_mode_equals_jax_recipe(tmp_path, monkeypatch):
    """``make_quant_goldens`` of both packages at the tiny configuration
    (the JAX tool's own code, its configuration swapped for the tiny
    one): the same file keys, prompt and Q4_0/Q4_1 ids."""
    make_goldens.make_quant_goldens(str(tmp_path / "port.npz"),
                                    config=BioGptConfig.tiny(**KW),
                                    device="cpu")
    monkeypatch.setattr(jax_config, "BioGptConfig",
                        lambda: JaxConfig.tiny(**KW))
    jax_goldens.make_quant_goldens(str(tmp_path / "jax.npz"))
    got, want = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["q4_0_greedy_ids"].shape == (len(make_goldens.PROMPT)
                                            + make_goldens.N_NEW_Q,)


def test_hf_mode_replays_through_the_port(tmp_path):
    """The HF mode at the tiny configuration writes the golden's keys; the
    port's f32 engine over the same seeded weights gives its greedy ids
    and its prefill logits' argmax."""
    cfg = BioGptConfig.tiny(**KW)
    out = tmp_path / "hf.npz"
    assert make_goldens.make_hf_goldens(str(out), config=cfg) == 0
    g = np.load(out)
    assert sorted(g.files) == ["final_logits", "greedy_ids", "prefill_logits",
                               "prompt", "scale", "seed"]
    prompt = g["prompt"].tolist()
    assert prompt == make_goldens.PROMPT
    eng = Engine(cfg, params_from_state_dict(make_goldens._state_dict(cfg),
                                             cfg, device="cpu"),
                 compute_dtype=torch.float32, cache_dtype=torch.float32,
                 max_seq=64, device="cpu")
    want = g["greedy_ids"].tolist()
    gen = GenerationParams(n_predict=make_goldens.N_NEW, temp=0.0,
                           stop_at_eos=False)
    assert eng.generate(prompt, gen).ids == want
    logits, _, _ = eng.prefill(eng.new_cache(), prompt)
    assert int(logits[0].argmax()) == int(g["prefill_logits"].argmax())


def test_check_goldens_gpu_exits_2_without_a_card(tmp_path, capsys):
    """2 on the CPU (a golden file given, and the committed one by
    default) and where the golden file is missing."""
    assert not torch.cuda.is_available()
    golden = tmp_path / "golden.npz"
    np.savez(golden, prompt=np.asarray(make_goldens.PROMPT, np.int32))
    for argv in ([str(golden)], []):
        assert check_goldens_gpu.main(argv) == 2
        assert "runs on the card" in capsys.readouterr().err
    assert check_goldens_gpu.main([str(tmp_path / "none.npz")]) == 2
    assert "no golden" in capsys.readouterr().err


def test_committed_gpu_golden():
    """Written by ``make_goldens --gpu-bf16`` on the card: the recipe's
    seed, scale and prompt, the prompt and 12 new ids a format, and the
    card's ``nvidia-smi`` name and power limit."""
    g = np.load(os.path.join(GOLDENS, check_goldens_gpu.GOLDEN))
    assert sorted(g.files) == ["device", "prompt", "q4_0_greedy_ids",
                               "q4_1_greedy_ids", "scale", "seed"]
    assert int(g["seed"]) == make_goldens.SEED
    assert float(g["scale"]) == np.float32(make_goldens.SCALE)
    prompt = make_goldens.PROMPT
    assert g["prompt"].tolist() == prompt
    for q in make_goldens.QTYPES:
        ids = g[f"{q}_greedy_ids"].tolist()
        assert len(ids) == len(prompt) + make_goldens.N_NEW_Q == 24
        assert ids[:len(prompt)] == prompt
        assert all(0 <= t < BioGptConfig().n_vocab for t in ids)
    device = str(g["device"])
    assert device.startswith("NVIDIA") and device.endswith(" W"), device
