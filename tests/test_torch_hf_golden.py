"""The HF golden at full size (BioGPT-347M) through the port's own loader.

``tests/goldens/hf347m_seed7.npz`` holds HF ``BioGptForCausalLM``'s prefill
logits and greedy continuation over seeded weights
(``biogpt_tpu.tools.make_goldens``: ``make_state_dict(seed=7, scale=0.1)``,
f32). The port builds its params from that state dict with its own
``params_from_state_dict`` (the JAX package's disk-cached draw feeds it)
and replays the golden on its f32 dense path on the CPU, with the JAX
test's tolerances (``tests/test_goldens.py``).
"""

import os

import numpy as np
import torch

from biogpt_tpu.config import BioGptConfig as JaxConfig
from biogpt_tpu.modelio.synthetic import make_state_dict as jax_make_state_dict

from biogpt_tpu_torch.config import BioGptConfig, GenerationParams
from biogpt_tpu_torch.modelio.checkpoint import params_from_state_dict
from biogpt_tpu_torch.runtime.engine import Engine

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "hf347m_seed7.npz")


def test_hf347m_golden_through_params_from_state_dict():
    golden = np.load(GOLDEN)
    # the npz stores the scale as f32; its shortest repr is make_goldens'
    # literal (0.1), which the draw and its cache key take
    scale = float(np.format_float_positional(np.float32(golden["scale"]),
                                             unique=True))
    sd = jax_make_state_dict(JaxConfig(), seed=int(golden["seed"]),
                             scale=scale)
    config = BioGptConfig()
    engine = Engine(config, params_from_state_dict(sd, config, device="cpu"),
                    compute_dtype=torch.float32, cache_dtype=torch.float32,
                    max_seq=64, device="cpu")
    del sd
    prompt = golden["prompt"].tolist()
    logits, _, _ = engine.prefill(engine.new_cache(), prompt)
    got = logits[0].numpy()
    want = golden["prefill_logits"].astype(np.float32)
    # the golden is stored in f16 (magnitudes O(100): resolution ~0.06)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=0.12)
    assert int(got.argmax()) == int(want.argmax())

    want_ids = golden["greedy_ids"].tolist()
    gen = GenerationParams(n_predict=len(want_ids) - len(prompt), temp=0.0,
                           stop_at_eos=False)
    toks = []
    assert engine.generate(prompt, gen, stream_cb=toks.append).ids == want_ids
    assert toks == want_ids[len(prompt):]
    assert engine.generate(prompt, gen).ids == want_ids
