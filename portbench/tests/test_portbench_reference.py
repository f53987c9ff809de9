"""The plain reference: its own block decoding against the port's codecs
bit for bit, its forward against the port's float32 CPU path at a tiny
configuration, its control (the reference in fp8) coming out as not
correct through each cell's verdict at a size a CPU test holds, and the
sampled tokens' numbers on tokens drawn as asked and drawn otherwise."""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import weights as W
from portbench import check
from portbench.run import HERE, load_file

REF = load_file(HERE / "configs" / "biogpt_ref.py", "portbench_reference")
TINY = dict(d_model=128, n_layer=2, n_head=2, d_ff=256, n_vocab=256,
            n_positions=64, pos_offset=2)


@pytest.mark.parametrize("fmt,ttype", [("q4_0", 2), ("q8_0", 8)])
def test_block_decoding_matches_the_codecs(fmt, ttype):
    from biogpt_tpu_torch.quant import codecs

    sw = W.make(TINY, fmt, 5, "cpu")
    mine = REF.dequant(torch.from_numpy(sw.blocks), fmt,
                       (sw.blocks.shape[0], 32)).numpy()
    assert np.array_equal(mine, codecs.dequantize_blocks(sw.blocks, ttype))


@pytest.mark.parametrize("fmt", ["q4_0", "q8_0"])
def test_forward_matches_the_ports_float32_path(fmt):
    from biogpt_tpu_torch.config import BioGptConfig
    from biogpt_tpu_torch.modelio.checkpoint import params_from_records
    from biogpt_tpu_torch.models.biogpt import logits_for_tokens

    sw = W.make(TINY, fmt, 11, "cpu")
    cfg = BioGptConfig(n_vocab=256, d_ff=256, d_model=128, n_layer=2,
                       n_head=2, n_positions=64)
    params = params_from_records(sw.records(), cfg)
    ids = np.random.default_rng(0).integers(4, 256, 40).tolist()
    port = logits_for_tokens(params, torch.tensor([ids]), cfg,
                             compute_dtype=torch.float32,
                             cache_dtype=torch.float32)[0]
    ref = REF.Reference(TINY, fmt, sw.blocks, sw.where, sw.dense,
                        "cpu").logits(ids)
    assert ref.shape == (40, 256)
    torch.testing.assert_close(ref, port, rtol=1e-4, atol=1e-4)


def test_weights_repeat_for_a_seed_and_differ_between_seeds():
    a, b, c = (W.make(TINY, "q4_0", s, "cpu") for s in (2**40, 2**40, 3))
    assert np.array_equal(a.blocks, b.blocks)
    assert not np.array_equal(a.blocks, c.blocks)
    d = np.frombuffer(a.blocks[:, :2].tobytes(), np.float16)
    assert d.min() >= 0.0049 and d.max() <= 0.0201


def greedy_requests(ref, n_vocab, seed, n_req, prompt, new):
    """Requests whose served tokens are the reference's own greedy ones."""
    from portbench.traffic import Req

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_req):
        ids = rng.integers(4, n_vocab, prompt).tolist()
        r = Req(prompt=list(ids), n_predict=new, greedy=True)
        with torch.no_grad():
            for _ in range(new):
                ids.append(int(ref.logits(ids)[-1].argmax()))
        r.new_ids = ids[prompt:]
        out.append(r)
    return out


def test_the_control_fails_the_limits():
    """BioGPT-347M's widths and vocabulary at 4 of its 24 layers on the CPU
    (the chip runs the 24: ``python -m portbench.calibrate``): the
    reference's greedy tokens read a gap of 0 against it, and the
    reference in fp8 in the program's place comes out as not correct
    through every cell's own verdict."""
    m = dict(TINY, d_model=1024, n_layer=4, n_head=16, d_ff=4096,
             n_vocab=42384, n_positions=1024)
    checks = [json.loads(p.read_text())["check"]
              for p in sorted((HERE / "workloads").glob("*.json"))]
    for fmt in ("q4_0", "q8_0"):
        sw = W.make(m, fmt, 4, "cpu")
        ref = REF.Reference(m, fmt, sw.blocks, sw.where, sw.dense, "cpu")
        reqs = greedy_requests(ref, m["n_vocab"], 1, 2, 16, 40)
        got = check.compare(ref, reqs, {
            "program": check.served,
            "control": check.control_source(ref, 4)})
        assert got["program"]["max_gap"] == 0.0
        assert got["program"]["tokens"] == 80
        for c in checks:
            # the greedy numbers alone, at these requests' 80 tokens
            c = dict(c, min_tokens=80, sample_sampled=0)
            assert check.verdict(reqs, got["program"], c)["correct"]
            assert not check.verdict(reqs, got["control"], c)["correct"], (
                fmt, got["control"])


class Logits:
    """A stand-in reference whose logits at every position are rows of a
    fixed random matrix (scaled as the cells' models read them)."""

    def __init__(self, n_vocab=4000, seed=0, scale=2.0):
        g = torch.Generator().manual_seed(seed)
        self.z = torch.randn(4096, n_vocab, generator=g) * scale

    def logits(self, ids, fp8=False):
        return self.z[:len(ids)]


def drawn_requests(ref, n_req, new, source, seed=0):
    """Sampled requests (top-k 40, top-p 0.9, temp 0.8) whose tokens
    ``source`` picks from the stand-in's logits."""
    from portbench.traffic import Req

    out = []
    for i in range(n_req):
        r = Req(prompt=[5, 6, 7], n_predict=new, greedy=False, temp=0.8,
                top_k=40, top_p=0.9)
        ids = r.prompt + [0] * new
        z = ref.logits(ids[:-1])[len(r.prompt) - 1:]
        r.new_ids = source(r, z, ids).tolist()
        out.append(r)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_tokens_drawn_as_asked_hold_and_faults_break(seed):
    ref = Logits(seed=seed)
    asked = check._fault()(seed)          # leaves out nothing
    reqs = drawn_requests(ref, 40, 100, asked)
    got = check.compare(ref, reqs)["program"]
    assert got["sampled_tokens"] == 4000 and got["tokens"] == 0
    assert got["sampled_topk_gap"] == 0.0
    assert got["sampled_pit_z"] < 4.0
    faults = {k: check.compare(ref, drawn_requests(ref, 40, 100, make(seed)))
              ["program"] for k, make in check.FAULTS.items()}
    assert faults["argmax"]["sampled_pit_z"] > 30
    assert faults["top_k_ignored"]["sampled_topk_gap"] > 1.0
    assert faults["top_p_ignored"]["sampled_pit_z"] > 8
    assert faults["temp_1"]["sampled_pit_z"] > 8


def test_mid_rank_terms_by_hand():
    from portbench.traffic import Req

    z = torch.log(torch.tensor([[0.5, 0.3, 0.2, 1e-9]]))
    r = Req(prompt=[1], n_predict=1, greedy=False, temp=1.0, top_k=3,
            top_p=0.75)
    # nucleus {0, 1}: q = (0.625, 0.375); mid-ranks 0.3125, 0.8125
    for tok, du in ((0, 0.3125 - 0.5), (1, 0.8125 - 0.5), (2, 0.5)):
        gap, got, var = check.sampled_terms(z, torch.tensor([tok]), r)
        assert got == pytest.approx(du)
        assert var == pytest.approx(0.625 * 0.3125**2 + 0.375 * 0.8125**2
                                    - 0.25)
        assert gap == 0.0
    gap, _, _ = check.sampled_terms(z, torch.tensor([3]), r)
    assert gap == pytest.approx(math.log(0.2) - math.log(1e-9), rel=1e-4)
