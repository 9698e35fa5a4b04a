"""repro_torch's continuous-batching server vs the JAX package, on the CPU.

``examples/serve_lm.py``'s tiny float32 model (4 layers, d_model 128),
the JAX ``init_params`` carried into the port, served by both packages'
``BatchedServer`` with 4 slots: 6 byte-tokenized prompts, 24 new tokens
each, admitted as slots free up. The port's greedy token lists equal the
JAX server's exactly. The same traffic through the moe (granite-moe,
deepseek-v2-lite with MLA), hybrid (recurrentgemma) and ssm (rwkv6) smoke
configs gives the JAX server's tokens too; the encdec and vlm models fail
at admission as the JAX server does (it passes tokens alone to
``prefill``). The byte tokenizer encodes and decodes as the JAX one does.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro import configs as jconfigs
from repro.configs import ModelConfig as JModelConfig
from repro.data import ByteTokenizer as JByteTokenizer
from repro.launch.serve import BatchedServer as JServer
from repro.launch.serve import Request as JRequest
from repro.models import build_model as j_build

from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.configs import ModelConfig
from repro_torch.data import ByteTokenizer
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model

CFG = dict(name="serve-tiny", family="dense", n_layers=4, d_model=128,
           n_heads=4, n_kv_heads=2, d_ff=384, vocab_size=4096,
           qkv_bias=True, norm="rmsnorm", activation="swiglu",
           dtype="float32", attn_chunk=128, remat=False)
PROMPTS = ["The projection matrix maps", "Back-projection is",
           "Cone beam computed tomography", "Performance portability means",
           "Vectorization on CPUs", "The subline buffer caches"]
NEW_TOKENS = 24
SLOTS = 4
MAX_LEN = 96


def _serve(server, requests):
    """The example's loop: admit while a slot is free, then one decode
    step for every active slot."""
    pending, done, steps = list(requests), [], 0
    while pending or any(r is not None for r in server.requests):
        while pending and server.submit(pending[0]):
            done.append(pending.pop(0))
        server.step()
        steps += 1
        assert steps <= 500
    return done, steps


@pytest.fixture(scope="module")
def served():
    jcfg = JModelConfig(**CFG)
    jp = j_build(jcfg).init(0)
    jtok = JByteTokenizer(jcfg.vocab_size)
    jdone, jsteps = _serve(
        JServer(jcfg, jp, slots=SLOTS, max_len=MAX_LEN),
        [JRequest(prompt=jtok.encode(p), max_new_tokens=NEW_TOKENS)
         for p in PROMPTS])
    cfg = ModelConfig(**CFG)
    model = convert.lm_params_from_reference(
        build_model(cfg, device="cpu"),
        jax.tree_util.tree_map(np.asarray, jp))
    tok = ByteTokenizer(cfg.vocab_size)
    server = tserve.BatchedServer(cfg, model, slots=SLOTS, max_len=MAX_LEN)
    done, steps = _serve(server, [
        tserve.Request(prompt=tok.encode(p), max_new_tokens=NEW_TOKENS)
        for p in PROMPTS])
    return dict(jdone=jdone, jsteps=jsteps, done=done, steps=steps,
                server=server)


def _serve_both(jcfg, cfg, new_tokens=NEW_TOKENS):
    """The JAX server and the port's (carrying the JAX tree) over the
    same prompts: (JAX requests, port requests, port server)."""
    jp = j_build(jcfg).init(0)
    jtok = JByteTokenizer(jcfg.vocab_size)
    jdone, _ = _serve(
        JServer(jcfg, jp, slots=SLOTS, max_len=MAX_LEN),
        [JRequest(prompt=jtok.encode(p), max_new_tokens=new_tokens)
         for p in PROMPTS])
    model = convert.lm_params_from_reference(
        build_model(cfg, device="cpu"),
        jax.tree_util.tree_map(np.asarray, jp))
    tok = ByteTokenizer(cfg.vocab_size)
    server = tserve.BatchedServer(cfg, model, slots=SLOTS, max_len=MAX_LEN)
    done, _ = _serve(server, [
        tserve.Request(prompt=tok.encode(p), max_new_tokens=new_tokens)
        for p in PROMPTS])
    return jdone, done, server


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "deepseek-v2-lite-16b",
                                  "recurrentgemma-9b", "rwkv6-3b"])
def test_family_tokens_equal_the_jax_server(arch):
    """Greedy tokens equal the JAX server's; every slot's state rows are
    the batch axis (1) of each leaf of the decode state."""
    jdone, done, server = _serve_both(jconfigs.get_smoke_config(arch),
                                      tconfigs.get_smoke_config(arch), 12)
    assert [r.out for r in done] == [r.out for r in jdone]
    assert all(len(r.out) == 12 for r in done)

    def leaves(tree):
        for v in tree.values():
            yield from (leaves(v) if isinstance(v, dict) else [v])
    assert all(a.shape[1] == SLOTS for a in leaves(server._cache))


@pytest.mark.parametrize("arch,key", [("seamless-m4t-medium", "frames"),
                                      ("internvl2-1b", "patches")])
def test_frontend_families_fail_as_the_jax_server(arch, key):
    """Both servers pass ``{"tokens": ...}`` alone to ``prefill``: the
    encdec model needs frames and the vlm model patches, so admission
    raises ``KeyError`` naming the missing input, in both packages."""
    jcfg = jconfigs.get_smoke_config(arch)
    jserver = JServer(jcfg, j_build(jcfg).init(0), slots=2, max_len=32)
    prompt = JByteTokenizer(jcfg.vocab_size).encode(PROMPTS[0])
    with pytest.raises(KeyError, match=key):
        jserver.submit(JRequest(prompt=prompt, max_new_tokens=4))
    cfg = tconfigs.get_smoke_config(arch)
    server = tserve.BatchedServer(cfg, build_model(cfg, device="cpu"),
                                  slots=2, max_len=32)
    with pytest.raises(KeyError, match=key):
        server.submit(tserve.Request(prompt=prompt, max_new_tokens=4))


def test_tokens_equal_the_jax_server(served):
    assert [r.out for r in served["done"]] == [
        r.out for r in served["jdone"]]
    assert served["steps"] == served["jsteps"]


def test_every_request_completes(served):
    assert len(served["done"]) == len(PROMPTS)
    for r in served["done"]:
        assert r.done and len(r.out) == NEW_TOKENS
        assert all(0 <= t < CFG["vocab_size"] for t in r.out)
    assert all(r is None for r in served["server"].requests)
    cache = served["server"]._cache
    assert tuple(cache["k"].shape) == (4, SLOTS, MAX_LEN, 2, 32)


def test_decode_state_like_is_abstract():
    model = build_model(ModelConfig(**CFG), device="cpu")
    like = tserve.decode_state_like(model, 3, 20)
    assert like["k"].device.type == "meta"
    assert tuple(like["v"].shape) == (4, 3, 20, 2, 32)
    step = tserve.make_decode_fn(model)
    cache = model.init_decode_state(3, 20)
    logits, cache2 = step(cache, torch.zeros((3, 1), dtype=torch.long), 0)
    assert tuple(logits.shape) == (3, 1, CFG["vocab_size"])
    assert cache2 is cache


def test_server_refusals():
    model = build_model(ModelConfig(**CFG), device="cpu")
    with pytest.raises(ValueError, match="built for"):
        tserve.BatchedServer(ModelConfig(**dict(CFG, name="other")), model)
    with pytest.raises(NotImplementedError, match="queue 1 item 2e"):
        tserve.shard_decode_step(model, None, None, 4, 16)


@pytest.mark.parametrize("text", ["", "Back-projection is", "héllo ✓",
                                  "tab\tnew\nline"])
@pytest.mark.parametrize("bos", [True, False])
def test_byte_tokenizer_matches_jax(text, bos):
    tok, jtok = ByteTokenizer(512), JByteTokenizer(512)
    ids = tok.encode(text, bos=bos)
    assert ids.dtype == np.int32
    assert np.array_equal(ids, jtok.encode(text, bos=bos))
    mixed = list(ids) + [ByteTokenizer.EOS, ByteTokenizer.PAD, 300]
    assert tok.decode(mixed) == jtok.decode(mixed) == text
    assert (tok.BOS, tok.EOS, tok.PAD) == (jtok.BOS, jtok.EOS, jtok.PAD)


def test_byte_tokenizer_needs_room_for_specials():
    with pytest.raises(ValueError, match="259"):
        ByteTokenizer(258)
