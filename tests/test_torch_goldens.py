"""Full-size (BioGPT-347M) quantized golden through the port.

``tests/goldens/own347m_seed7_quant.npz`` holds the JAX engine's Q4_0 and
Q4_1 greedy continuations over seed-7 weights
(``biogpt_tpu.tools.make_goldens``, f32 compute, unpacked planes, per-op
path). The port replays it on its own
f32 unpacked path from the same planes, carried across by
``params_from_numpy``; the ids must match exactly.
"""

import os

import numpy as np
import pytest

from biogpt_tpu.config import BioGptConfig
from biogpt_tpu.modelio.checkpoint import params_from_state_dict
from biogpt_tpu.modelio.synthetic import make_state_dict
from biogpt_tpu.quant.codecs import GGML_TYPE_BY_NAME
from biogpt_tpu.tools.make_goldens import SCALE, SEED

import torch

from biogpt_tpu_torch.config import BioGptConfig as TorchConfig
from biogpt_tpu_torch.config import GenerationParams
from biogpt_tpu_torch.modelio.checkpoint import params_from_numpy
from biogpt_tpu_torch.runtime.engine import Engine

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "own347m_seed7_quant.npz")


@pytest.mark.parametrize("qname", ["q4_0", "q4_1"])
def test_347m_golden_replays_exactly(qname):
    golden = np.load(GOLDEN)
    assert int(golden["seed"]) == SEED
    # the weights of make_goldens._quant_engine(qname, ...): seeded state
    # dict (disk-cached at full size) through the real codec
    params = params_from_state_dict(
        make_state_dict(BioGptConfig(), seed=SEED, scale=SCALE),
        BioGptConfig(), qtype=GGML_TYPE_BY_NAME[qname])
    engine = Engine(TorchConfig(), params_from_numpy(params, device="cpu"),
                    compute_dtype=torch.float32, cache_dtype=torch.float32,
                    max_seq=64, pack_q4=False, device="cpu")
    del params
    prompt = golden["prompt"].tolist()
    want = golden[f"{qname}_greedy_ids"].tolist()
    gen = GenerationParams(n_predict=len(want) - len(prompt), temp=0.0,
                           stop_at_eos=False)
    toks = []
    got = engine.generate(prompt, gen, stream_cb=toks.append).ids
    assert got == want
    assert toks == want[len(prompt):]
