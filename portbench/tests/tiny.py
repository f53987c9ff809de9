"""The cells cut to a size the CPU tests hold: BioGPT's shape at widths
128 / 256, 2 layers, 2 heads, a 256-token vocabulary and 64 positions;
4 slots and chunks of 4; a few short requests."""


def tweak(cfg, wl):
    cfg.update(hidden_size=128, intermediate_size=256, num_attention_heads=2,
               num_hidden_layers=2, vocab_size=256, max_position_embeddings=64)
    e = cfg["engine"]
    if "max_batch" in e:
        e.update(max_batch=4, chunk=4)
    e["max_seq"] = 64
    p, r = wl["params"], wl["params"]["requests"]
    if wl["kind"] == "closed_batch":
        p["call_requests"] = 8
        r.update(prompt_len=[[1.0, 4, 12]], n_predict={"uniform": [4, 16]})
    elif wl["kind"] == "stream":
        p["pool_size"] = 8
        r.update(prompt_len=[[1.0, 4, 12]], n_predict={"value": 12})
        if r.get("greedy_share", 1.0) < 1.0:
            r["greedy_share"] = 0.5
    else:
        p.update(rate=20.0, tail_s=0.5, wait_s=30.0)
        r.update(prompt_len=[[0.6, 5, 12], [0.4, 20, 30]],
                 n_predict={"choices": [4, 8]})
    wl["check"]["min_tokens"] = 4
    if "sample_sampled" in wl["check"]:
        wl["check"].update(sample_sampled=16, min_sampled_tokens=4)


CELLS = ("q4_0.batch32.decode", "q8_0.stream.sampled", "q4_0.serve.mixed",
         "q8_0.stream.greedy")


def tweak_deep(cfg, wl):
    """:func:`tweak`, 8 layers deep at widths 256 / 1024 and a 512-token
    vocabulary: deep enough that a served token's logit depends on its
    context as at 24 layers (2 layers hardly read the KV cache)."""
    tweak(cfg, wl)
    cfg.update(hidden_size=256, intermediate_size=1024, num_attention_heads=4,
               num_hidden_layers=8, vocab_size=512,
               max_position_embeddings=128)
    cfg["engine"]["max_seq"] = 128
    r = wl["params"]["requests"]
    if "uniform" in r["n_predict"]:
        r["n_predict"] = {"uniform": [16, 32]}
    elif "value" in r["n_predict"]:
        r["n_predict"] = {"value": 24}
    else:
        r["n_predict"] = {"choices": [12, 24]}
