"""The port's prompt-refiner lane (``physicedit_torch/models/bloom.py``,
``models/marian.py``, ``pipeline/prompt_refiners.py``) against the JAX
package's, and against transformers' own models as tests/test_prompt_refiners.py
holds JAX's, on the CPU in fp32.

The same tiny random HF models give both packages their weights (the JAX
trees also carried into the port by ``io/from_jax.py``).  Logits within 1e-5
relative of JAX's (2e-4 of transformers', as JAX is held); greedy tokens and
refiner strings equal.  Sampled generation draws from a ``torch.Generator``
where JAX draws from ``jax.random``, so its tokens are held to repeatability
under one seed and to the top-k / top-p support, and the warpers to JAX's
and transformers' on the same logits.  Tokenizers are stubs.
"""

import argparse

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from physicedit_tpu.models import bloom as jb
from physicedit_tpu.models import marian as jm
from physicedit_tpu.pipeline import prompt_refiners as jpr
from physicedit_torch.io.from_jax import bloom_from_jax, marian_from_jax
from physicedit_torch.models import bloom as tb
from physicedit_torch.models import marian as tm
from physicedit_torch.pipeline import prompt_refiners as tpr

torch.set_num_threads(2)

LOGIT_REL = 1e-5


def _rel_close(got, want, rel=LOGIT_REL):
    err = np.abs(np.asarray(got) - np.asarray(want)).max()
    assert err <= rel * np.abs(np.asarray(want)).max(), err


# ---------------------------------------------------------------------------
# BLOOM
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bloom_pair():
    from transformers import BloomConfig as HFBloomConfig
    from transformers import BloomForCausalLM

    torch.manual_seed(0)
    hf_cfg = HFBloomConfig(vocab_size=97, hidden_size=32, n_layer=2, n_head=4,
                           bos_token_id=1, eos_token_id=2, pad_token_id=3)
    hf = BloomForCausalLM(hf_cfg).eval()
    sd = dict(hf.state_dict())
    cfg = jb.config_from_hf(hf_cfg)
    params = jb.bloom_from_torch(sd, cfg, jnp.float32)
    model = tb.bloom_from_state_dict(sd, tb.config_from_hf(hf_cfg), device="cpu")
    return hf, cfg, params, model


def _left_padded(cfg, rng, b, s, pads):
    ids = rng.integers(4, cfg.vocab_size, size=(b, s))
    mask = np.ones((b, s), np.int64)
    for r, p in enumerate(pads):
        ids[r, :p] = cfg.pad_token_id
        mask[r, :p] = 0
    return ids, mask


def test_bloom_logits_parity_batched_left_pad(bloom_pair):
    """Teacher-forced logits with different pads per row (the mask-aware
    ALiBi positions) against transformers and JAX; the torch-layout loader
    and the JAX tree carried across give the same model."""
    hf, cfg, params, model = bloom_pair
    ids, mask = _left_padded(cfg, np.random.default_rng(0), 2, 12, [5, 2])
    with torch.no_grad():
        ref = hf(input_ids=torch.tensor(ids), attention_mask=torch.tensor(mask)).logits.numpy()
    want = np.asarray(jb.bloom_logits(params, cfg, jnp.asarray(ids, jnp.int32),
                                      jnp.asarray(mask)))
    carried = bloom_from_jax(params, cfg, device="cpu")
    valid = mask.astype(bool)
    for m in (model, carried):
        got = tb.bloom_logits(m, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
        np.testing.assert_allclose(got[valid], ref[valid], rtol=2e-4, atol=2e-4)
        _rel_close(got[valid], want[valid])


def test_bloom_greedy_generate_parity(bloom_pair):
    """Greedy continuations equal JAX's token for token (two rows, different
    pads, a repetition penalty) and a manual transformers argmax loop."""
    hf, cfg, params, model = bloom_pair
    rng = np.random.default_rng(1)
    n_new = 6
    ids, mask = _left_padded(cfg, rng, 1, 8, [3])
    cur_ids, cur_mask = torch.tensor(ids), torch.tensor(mask)
    ref = []
    with torch.no_grad():
        for _ in range(n_new):
            nxt = hf(input_ids=cur_ids, attention_mask=cur_mask).logits[:, -1].argmax(-1)
            ref.append(int(nxt))
            cur_ids = torch.cat([cur_ids, nxt[:, None]], 1)
            cur_mask = torch.cat([cur_mask, torch.ones((1, 1)).long()], 1)
    got = tb.bloom_generate(model, torch.from_numpy(ids), torch.from_numpy(mask),
                            max_new_tokens=n_new)
    assert got[0].tolist() == ref
    ids2, mask2 = _left_padded(cfg, rng, 2, 10, [4, 0])
    want = jb.bloom_generate(params, cfg, jnp.asarray(ids2, jnp.int32), jnp.asarray(mask2),
                             max_new_tokens=7, repetition_penalty=1.1)
    got = tb.bloom_generate(model, torch.from_numpy(ids2), torch.from_numpy(mask2),
                            max_new_tokens=7, repetition_penalty=1.1)
    assert got.tolist() == np.asarray(want).tolist()


def test_bloom_rep_penalty_matches_hf():
    from transformers import RepetitionPenaltyLogitsProcessor

    rng = np.random.default_rng(2)
    logits = rng.normal(size=(1, 50)).astype(np.float32)
    ids = np.array([[3, 7, 7, 11]])
    ref = RepetitionPenaltyLogitsProcessor(penalty=1.1)(
        torch.tensor(ids), torch.tensor(logits.copy())).numpy()
    counts = np.zeros((1, 50), np.int32)
    np.add.at(counts[0], ids[0], 1)
    want = np.asarray(jb._apply_rep_penalty(jnp.asarray(logits), jnp.asarray(counts), 1.1))
    got = tb._apply_rep_penalty(torch.from_numpy(logits), torch.from_numpy(counts), 1.1).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    np.testing.assert_array_equal(got, want)


def test_bloom_top_k_top_p_matches_hf():
    """The same keep-set and kept logits as transformers' TopK then TopP
    warpers, and JAX's filtered logits exactly."""
    from transformers import TopKLogitsWarper, TopPLogitsWarper

    rng = np.random.default_rng(3)
    logits = rng.normal(size=(2, 64)).astype(np.float32) * 3
    ref = TopKLogitsWarper(top_k=10)(None, torch.tensor(logits.copy()))
    ref = TopPLogitsWarper(top_p=0.9)(None, ref).numpy()
    got = tb._top_k_top_p(torch.from_numpy(logits), 10, 0.9).numpy()
    keep_ref, keep_got = np.isfinite(ref) & (ref > -1e8), got > -1e8
    assert (keep_ref == keep_got).all()
    np.testing.assert_allclose(got[keep_got], ref[keep_ref], rtol=1e-6)
    np.testing.assert_array_equal(got, np.asarray(jb._top_k_top_p(jnp.asarray(logits), 10, 0.9)))


def test_bloom_alibi_slopes_non_power_of_two():
    """A 6-head model against transformers' build_alibi_tensor, and JAX's."""
    from transformers.models.bloom.modeling_bloom import build_alibi_tensor

    ref = build_alibi_tensor(torch.ones(1, 4), 6, torch.float32)   # [6, 1, 4]
    np.testing.assert_allclose(tb.alibi_slopes(6), ref[:, 0, -1].numpy() / 3.0, rtol=1e-6)
    for n in (6, 16, 12):
        np.testing.assert_array_equal(tb.alibi_slopes(n), jb.alibi_slopes(n))


def test_bloom_sampling_repeatable_and_inside_the_support(bloom_pair):
    """Sampled generation (BeautifulPrompt's kwargs): the same seed gives the
    same tokens, another seed others, and every drawn token is inside the
    top-k / top-p support of its step's logits (recomputed teacher-forced,
    with the repetition penalty of the tokens before it)."""
    _, cfg, _, model = bloom_pair
    ids, mask = _left_padded(cfg, np.random.default_rng(4), 2, 9, [3, 0])
    kw = dict(max_new_tokens=10, do_sample=True, temperature=0.9, top_k=5, top_p=0.8,
              repetition_penalty=1.1)

    def run(seed):
        return tb.bloom_generate(model, torch.from_numpy(ids), torch.from_numpy(mask),
                                 generator=torch.Generator().manual_seed(seed), **kw)

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    for toks in (a, c):
        seq = torch.cat([torch.from_numpy(ids), toks], 1)
        full_mask = torch.cat([torch.from_numpy(mask), torch.ones_like(toks)], 1)
        logits = tb.bloom_logits(model, seq, full_mask)
        for r in range(2):
            for i in range(toks.shape[1]):
                if (toks[r, :i] == cfg.eos_token_id).any():
                    break
                pos = ids.shape[1] + i - 1
                counts = torch.zeros((1, cfg.vocab_size), dtype=torch.int32)
                prior = seq[r, :pos + 1][full_mask[r, :pos + 1] > 0]
                counts[0].scatter_add_(0, prior, torch.ones_like(prior, dtype=torch.int32))
                lf = tb._apply_rep_penalty(logits[r:r + 1, pos], counts, 1.1)
                lf = tb._top_k_top_p(lf / 0.9, 5, 0.8)
                assert lf[0, toks[r, i]] > -1e8, (r, i)


# ---------------------------------------------------------------------------
# Marian
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def marian_pair():
    from transformers import MarianConfig as HFMarianConfig
    from transformers import MarianMTModel

    torch.manual_seed(0)
    hf_cfg = HFMarianConfig(
        vocab_size=73, d_model=32, encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=4, decoder_attention_heads=4, encoder_ffn_dim=64,
        decoder_ffn_dim=64, max_position_embeddings=64, scale_embedding=True,
        activation_function="swish", pad_token_id=72, eos_token_id=0,
        decoder_start_token_id=72, share_encoder_decoder_embeddings=True)
    hf = MarianMTModel(hf_cfg).eval()
    sd = dict(hf.state_dict())
    cfg = jm.config_from_hf(hf_cfg)
    params = jm.marian_from_torch(sd, cfg, jnp.float32)
    model = tm.marian_from_state_dict(sd, tm.config_from_hf(hf_cfg), device="cpu")
    return hf, cfg, params, model


def test_marian_teacher_forced_logits_parity(marian_pair):
    hf, cfg, params, model = marian_pair
    rng = np.random.default_rng(0)
    src = rng.integers(1, 70, size=(2, 9))
    mask = np.ones((2, 9), np.int64)
    src[1, 6:] = cfg.pad_token_id
    mask[1, 6:] = 0
    dec = rng.integers(1, 70, size=(2, 5))
    with torch.no_grad():
        ref = hf(input_ids=torch.tensor(src), attention_mask=torch.tensor(mask),
                 decoder_input_ids=torch.tensor(dec)).logits.numpy()
    enc_j = jm.marian_encode(params, cfg, jnp.asarray(src, jnp.int32), jnp.asarray(mask))
    want = np.asarray(jm.marian_decode_logits(params, cfg, jnp.asarray(dec, jnp.int32), enc_j,
                                              jnp.asarray(mask)))
    for m in (model, marian_from_jax(params, cfg, device="cpu")):
        enc = tm.marian_encode(m, torch.from_numpy(src), torch.from_numpy(mask))
        _rel_close(enc.numpy(), np.asarray(enc_j))
        got = tm.marian_decode_logits(m, torch.from_numpy(dec), enc,
                                      torch.from_numpy(mask)).numpy()
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
        _rel_close(got, want)


def test_marian_greedy_generate_parity(marian_pair):
    """Greedy decode against a manual transformers argmax loop from
    decoder_start, and JAX's tokens at two rows with a pad."""
    hf, cfg, params, model = marian_pair
    rng = np.random.default_rng(1)
    n_new = 6
    src = rng.integers(1, 70, size=(1, 7))
    mask = np.ones((1, 7), np.int64)
    dec = torch.tensor([[cfg.decoder_start_token_id]])
    ref = []
    with torch.no_grad():
        for _ in range(n_new):
            nxt = hf(input_ids=torch.tensor(src), attention_mask=torch.tensor(mask),
                     decoder_input_ids=dec).logits[:, -1].argmax(-1)
            ref.append(int(nxt))
            dec = torch.cat([dec, nxt[:, None]], 1)
    got = tm.marian_greedy_generate(model, torch.from_numpy(src), torch.from_numpy(mask),
                                    max_new_tokens=n_new)
    assert got[0].tolist() == ref
    src2 = rng.integers(1, 70, size=(2, 8))
    mask2 = np.ones((2, 8), np.int64)
    src2[0, 5:], mask2[0, 5:] = cfg.pad_token_id, 0
    want = jm.marian_greedy_generate(params, cfg, jnp.asarray(src2, jnp.int32),
                                     jnp.asarray(mask2), max_new_tokens=9)
    got = tm.marian_greedy_generate(model, torch.from_numpy(src2), torch.from_numpy(mask2),
                                    max_new_tokens=9)
    assert got.tolist() == np.asarray(want).tolist()


def test_marian_sinusoidal_table_matches_hf(marian_pair):
    """The position table is not learned: transformers fills it in
    _init_weights, so it is pinned against the instantiated model's."""
    hf, cfg, _, model = marian_pair
    ref = hf.model.encoder.embed_positions.weight.detach().numpy()
    got = tm.sinusoidal_table(cfg.max_positions, cfg.d_model)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got, jm.sinusoidal_table(cfg.max_positions, cfg.d_model))
    torch.testing.assert_close(model.pos, torch.from_numpy(ref))


# ---------------------------------------------------------------------------
# The refiners (stub tokenizers; tiny weights)
# ---------------------------------------------------------------------------

class StubTokenizer:
    eos_token_id = 2

    def encode(self, text):
        return list(range(4, 4 + max(3, len(text) % 7)))

    def apply_chat_template(self, messages, tokenize=False, add_generation_prompt=True):
        return " ".join(m["content"] for m in messages)

    def decode(self, toks, skip_special_tokens=True):
        return " ".join(f"t{t}" for t in toks)


def test_beautiful_prompt_appends_generation(bloom_pair):
    """raw + ", " + the generation; a negative prompt passes through; one
    seed repeats, and the V1 template is the default."""
    _, cfg, _, model = bloom_pair
    ref = tpr.BeautifulPrompt(model, StubTokenizer())
    assert ref.template == tpr.BEAUTIFUL_TEMPLATE_V1 == jpr.BEAUTIFUL_TEMPLATE_V1
    assert tpr.BEAUTIFUL_TEMPLATE_V2 == jpr.BEAUTIFUL_TEMPLATE_V2
    out = ref("a cat", seed=0)
    assert out.startswith("a cat, ") and len(out) > len("a cat, ")
    assert ref("a cat", seed=0) == out
    assert ref("neg", positive=False) == "neg"


def test_translator_decodes_to_eos(marian_pair):
    """Every emitted id is before EOS (0 here), and the string is JAX's."""
    _, cfg, params, model = marian_pair
    got = tpr.Translator(model, StubTokenizer())("一只猫", max_new_tokens=5)
    want = jpr.Translator(params, cfg, StubTokenizer())("一只猫", max_new_tokens=5)
    assert isinstance(got, str) and "t0" not in got.split()
    assert got == want


class _FakeText(torch.nn.Module):
    """A text model whose prefill makes token 7 first and whose decode emits
    [7, 8, 9] then EOS."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.norm = torch.nn.Module()
        self.norm.scale = torch.nn.Parameter(torch.ones(cfg.hidden_size))
        self.first = None

    def embed_tokens(self, ids):
        return torch.zeros((ids.shape[0], self.cfg.hidden_size))

    def prefill(self, embeds, pos, mask, max_total_len, **kw):
        logits = torch.zeros((1, self.cfg.vocab_size))
        logits[0, 7] = 10.0
        return logits, "CACHES", None

    def greedy_decode(self, caches, first, start_pos, rope_pos, max_new_tokens, key_mask=None):
        self.first = int(first[0])
        toks = torch.full((1, max_new_tokens), self.cfg.eos_token_id)
        toks[0, :3] = torch.tensor([7, 8, 9])
        return toks, 3


def test_qwen_prompt_no_first_token_duplication():
    """greedy_decode already returns the first token at position 0; the
    refiner does not prepend it again."""
    from physicedit_torch.models.qwen_vl import TINY_TEXT

    text = _FakeText(TINY_TEXT)
    out = tpr.QwenPrompt(text, StubTokenizer())("一只猫", max_new_tokens=8)
    assert text.first == 7 and out.split() == ["t7", "t8", "t9"]


def test_qwen_text_cfg_from_hf_forwards_head_dim():
    hf = {"vocab_size": 151936, "hidden_size": 896, "num_hidden_layers": 24,
          "num_attention_heads": 14, "num_key_value_heads": 2, "intermediate_size": 4864,
          "rope_theta": 1e6, "rms_norm_eps": 1e-6,
          "eos_token_id": [151645, 151643]}       # Qwen2-0.5B-Instruct's shapes
    cfg = tpr.qwen_text_cfg_from_hf(hf)
    assert cfg.head_dim == 64 and sum(cfg.mrope_section) == 32 and cfg.eos_token_id == 151645
    want = jpr.qwen_text_cfg_from_hf(hf)
    assert {f: getattr(cfg, f) for f in cfg.__dataclass_fields__} == {
        f: getattr(want, f) for f in cfg.__dataclass_fields__}
    hf["head_dim"] = 128                           # an explicit head_dim wins
    assert tpr.qwen_text_cfg_from_hf(hf).head_dim == 128
    full = tpr.qwen_text_cfg_from_hf(tpr.QWEN2_1_5B_INSTRUCT)
    assert (full.head_dim, full.num_heads, full.num_kv_heads) == (128, 12, 2)


def test_make_prompt_refiner_factory(monkeypatch):
    calls = {}

    class Fake:
        @classmethod
        def from_pretrained(cls, path, device="cuda"):
            calls.update(path=path, device=device)
            return cls()

        def __call__(self, prompt, positive=True):
            return prompt + "!"

    monkeypatch.setitem(tpr.REFINER_KINDS, "qwen", Fake)
    fn = tpr.make_prompt_refiner("qwen:/models/qwen2")
    assert calls == {"path": "/models/qwen2", "device": "cuda"}
    assert fn("hello") == "hello!"
    tpr.make_prompt_refiner("qwen:/m", device="cpu")
    assert calls["device"] == "cpu"
    assert tpr.make_prompt_refiner(None) is None
    assert sorted(tpr.REFINER_KINDS) == sorted(jpr.REFINER_KINDS)
    with pytest.raises(ValueError):
        tpr.make_prompt_refiner("nope:/x")
    with pytest.raises(ValueError):
        tpr.make_prompt_refiner("just-a-path")


def test_make_prompt_preprocessor_chains(monkeypatch, tmp_path):
    """The refiner runs first, then the rewriter command, as in JAX."""
    from physicedit_torch.cli import serving

    seen = {}

    class T:
        @classmethod
        def from_pretrained(cls, path, device="cuda"):
            seen["device"] = device
            return lambda p, **k: p + " EN"

    monkeypatch.setitem(tpr.REFINER_KINDS, "translate", T)
    script = tmp_path / "up.sh"
    script.write_text("#!/bin/sh\ntr a-z A-Z\n")
    script.chmod(0o755)
    args = argparse.Namespace(prompt_refiner="translate:/x", prompt_rewriter_cmd=str(script),
                              device="cpu")
    fn = serving.make_prompt_preprocessor(args)
    assert fn("cat") == "CAT EN" and seen["device"] == "cpu"
    none_args = argparse.Namespace(prompt_refiner=None, prompt_rewriter_cmd=None)
    assert serving.make_prompt_preprocessor(none_args) is None


# ---------------------------------------------------------------------------
# from_pretrained on HF folders, against the JAX package's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hf_folders(tmp_path_factory, bloom_pair, marian_pair):
    """save_pretrained folders of the tiny BLOOM and Marian and of a tiny
    Qwen2 with tied embeddings."""
    from transformers import Qwen2Config, Qwen2ForCausalLM

    base = tmp_path_factory.mktemp("hf")
    torch.manual_seed(1)
    qwen = Qwen2ForCausalLM(Qwen2Config(
        vocab_size=97, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, tie_word_embeddings=True,
        eos_token_id=2, rope_theta=1e6)).eval()
    with torch.no_grad():       # spread the logits so greedy decoding is not a near-tie
        qwen.model.embed_tokens.weight.normal_(0.0, 0.5)
    paths = {}
    for name, model in (("bloom", bloom_pair[0]), ("marian", marian_pair[0]), ("qwen", qwen)):
        paths[name] = str(base / name)
        model.save_pretrained(paths[name])
    return paths


def test_refiners_from_pretrained_match_jax(hf_folders):
    """Each refiner loaded from its HF folder by both packages: BLOOM's and
    Marian's weights equal the JAX trees carried across, Translator and
    QwenPrompt return JAX's strings, and BeautifulPrompt keeps its shape."""
    tok = StubTokenizer()
    b_t = tpr.BeautifulPrompt.from_pretrained(hf_folders["bloom"], tok, torch.float32, "cpu")
    b_j = jpr.BeautifulPrompt.from_pretrained(hf_folders["bloom"], tok, jnp.float32)
    carried = bloom_from_jax(b_j.params, b_j.cfg, device="cpu")
    for (name, p), q in zip(b_t.model.state_dict().items(), carried.state_dict().values()):
        assert torch.equal(p, q), name
    assert b_t("a dog", seed=3).startswith("a dog, ")

    tr_t = tpr.Translator.from_pretrained(hf_folders["marian"], tok, device="cpu")
    tr_j = jpr.Translator.from_pretrained(hf_folders["marian"], tok)
    for (name, p), q in zip(tr_t.model.state_dict().items(),
                            marian_from_jax(tr_j.params, tr_j.cfg, device="cpu")
                            .state_dict().values()):
        assert torch.equal(p, q), name
    assert tr_t("一只红色的猫", max_new_tokens=6) == tr_j("一只红色的猫", max_new_tokens=6)

    q_t = tpr.QwenPrompt.from_pretrained(hf_folders["qwen"], tok, torch.float32, "cpu")
    q_j = jpr.QwenPrompt.from_pretrained(hf_folders["qwen"], tok, jnp.float32)
    assert q_t.cfg.num_kv_heads == 2 and q_t.cfg.head_dim == 16
    got, want = q_t("一只猫", max_new_tokens=6), q_j("一只猫", max_new_tokens=6)
    assert got == want and len(got) > 0
    assert q_t("x", positive=False) == "x"


def test_qwen_prompt_prefill_matches_jax(hf_folders):
    """QwenPrompt's left-padded /128 prefill: the last row's logits against
    JAX's (the refiner reads only that row; left-pad rows are compared
    nowhere, the port giving 0 where JAX gives a block-size-dependent mean)."""
    from physicedit_tpu.models import qwen_vl as j_text

    tok = StubTokenizer()
    q_t = tpr.QwenPrompt.from_pretrained(hf_folders["qwen"], tok, torch.float32, "cpu")
    q_j = jpr.QwenPrompt.from_pretrained(hf_folders["qwen"], tok, jnp.float32)
    ids, embeds, pos, mask = q_t.inputs("一只猫")
    assert mask.shape == (1, 128) and int(mask.sum()) == len(ids)
    logits, _, _ = q_t.text.prefill(embeds, pos, mask, 128 + 4)
    want, _, _ = j_text.prefill(q_j.params, q_j.cfg, jnp.asarray(embeds.numpy()),
                                jnp.asarray(pos.numpy()), jnp.asarray(mask.numpy()),
                                max_total_len=128 + 4)
    _rel_close(logits.numpy(), np.asarray(want))
