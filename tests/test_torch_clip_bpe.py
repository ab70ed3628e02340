"""The port's CLIP BPE (``extensions/clip_bpe.py``, standard library and
NumPy only) against the JAX package's ``ClipBpeTokenizer``, which
pre-tokenizes with the ``regex`` package, on a synthetic merge file."""

import gzip
import os
import subprocess
import sys
import textwrap
import unicodedata

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from physicedit_tpu.extensions.clip_bpe import ClipBpeTokenizer as JaxBpe
from physicedit_tpu.extensions.clip_bpe import _clean as jax_clean
from physicedit_torch.extensions import clip_bpe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MERGES = ["i n", "t h", "th e</w>", "a n", "an d</w>", "in g</w>", "h e", "o v", "ov e",
          "ove r</w>", "t i", "ti p", "tip s</w>", "c u", "cu p</w>", "' s</w>", "Ã ©",
          "ĠŁ ı", "æ Ī", "1 2"]

TEXTS = [
    "the cup tips over", "And THE glass, breaking!", "ink & ether", "over-the-top",
    # contractions, checked before letters; and case-folded
    "it's the cup's handle, they're here, we've, I'm, you'll, he'd", "IT'S THEY'LL",
    "'sun 'dog ''s", "\u017f '\u017f",
    # the special tokens as text, and their neighbours
    "<|startoftext|>a cup<|endoftext|>", "<<|endoftext|> !<|endoftext|>", "<|STARTOFTEXT|>",
    # CJK, numbers beyond ASCII, emoji, symbols
    "一只猫 sits on a red chair", "x² + ½ = ③ and Ⅻ", "🙂🙃 rocket🚀!!", "٣٤ and ۵",
    "café naïve Ωmega", "\u0345\u0345 a combining mark", "tabs\tand\nnew  lines　wide",
    "&amp;lt;b&amp;gt; &quot;quoted&quot;", "", "   ",
]


@pytest.fixture(scope="module")
def bpe_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bpe") / "bpe_simple_vocab_16e6.txt.gz")
    with gzip.open(path, "wt") as f:
        f.write("#version: tiny\n" + "\n".join(MERGES) + "\n")
    return path


@pytest.fixture(scope="module")
def pair(bpe_path):
    return JaxBpe(bpe_path), clip_bpe.ClipBpeTokenizer(bpe_path)


def _jax_split(jtok, text):
    return jtok._pat.findall(jax_clean(text).lower())


def test_vocabulary_matches_jax(pair):
    jtok, ttok = pair
    assert ttok.encoder == jtok.encoder and ttok.bpe_ranks == jtok.bpe_ranks
    assert (ttok.sot, ttok.eot) == (jtok.sot, jtok.eot) == (512 + len(MERGES),
                                                              513 + len(MERGES))


def test_full_vocabulary_budget(tmp_path):
    """The default budget takes 49152 - 256 - 2 merges: SOT / EOT at 49406 /
    49407 over a long enough merge list, as JAX's."""
    merges = [f"a{i} b{i}" for i in range(49152)]
    path = str(tmp_path / "long.txt.gz")
    with gzip.open(path, "wt") as f:
        f.write("#version\n" + "\n".join(merges) + "\n")
    tok = clip_bpe.ClipBpeTokenizer(path)
    assert (tok.sot, tok.eot) == (49406, 49407) == (JaxBpe(path).sot, JaxBpe(path).eot)


@pytest.mark.parametrize("i", range(len(TEXTS)))
def test_split_and_encode_match_jax(pair, i):
    jtok, ttok = pair
    text = TEXTS[i]
    assert clip_bpe.pre_tokenize(clip_bpe._clean(text).lower()) == _jax_split(jtok, text)
    assert ttok.encode(text) == jtok.encode(text)
    assert ttok.decode(ttok.encode(text)) == jtok.decode(jtok.encode(text))


@pytest.mark.parametrize("context_length", [77, 12, 4])
def test_tokenize_matches_jax(pair, context_length):
    """SOT / EOT framing, zero padding and truncation (EOT kept last)."""
    jtok, ttok = pair
    texts = ["the cup tips over", "x" * 40, "一只猫 sits", "and"]
    got = ttok.tokenize(texts, context_length)
    assert got.dtype == np.int32 and got.shape == (4, context_length)
    np.testing.assert_array_equal(got, jtok.tokenize(texts, context_length))
    np.testing.assert_array_equal(ttok.tokenize("and", context_length),
                                  jtok.tokenize("and", context_length))


def test_byte_encoder_is_cached():
    assert clip_bpe._bytes_to_unicode() is clip_bpe._bytes_to_unicode()
    from physicedit_tpu.extensions.clip_bpe import _bytes_to_unicode

    assert clip_bpe._bytes_to_unicode() == _bytes_to_unicode()


# every category Python's unicodedata assigns (no Cn, no surrogates)
CATEGORIES = ["Lu", "Ll", "Lt", "Lm", "Lo", "Mn", "Mc", "Me", "Nd", "Nl", "No", "Pc", "Pd",
              "Ps", "Pe", "Pi", "Pf", "Po", "Sm", "Sc", "Sk", "So", "Zs", "Zl", "Zp", "Cc",
              "Cf", "Co"]
PIECES = st.sampled_from(["'s", "'S", "'t", "'re", "'ve", "'m", "'ll", "'d", "'", "\u017f",
                          "\u0345", "<|startoftext|>", "<|endoftext|>", "<|", "|>", " ",
                          "²", "½", "猫", "🙂", "&amp;", "\x1c"])
TEXT = st.lists(st.one_of(st.characters(categories=CATEGORIES), PIECES),
                max_size=24).map("".join)


@settings(max_examples=300, deadline=None, database=None)
@given(text=TEXT)
def test_hypothesis_split_and_encode_match_jax(pair, text):
    """Text drawn across every assigned Unicode category, with contractions,
    special tokens and the characters whose classes differ between ``re``
    and ``regex`` mixed in: the port splits and encodes as JAX's regex
    pattern does."""
    jtok, ttok = pair
    assert clip_bpe.pre_tokenize(clip_bpe._clean(text).lower()) == _jax_split(jtok, text)
    assert ttok.encode(text) == jtok.encode(text)


def test_letters_are_unicode_categories_not_word_classes():
    """``[^\\W\\d_]`` would take No / Nl numbers as letters; the port's
    letters are exactly the L* categories."""
    for c in "²½ⅫⅰA猫":
        kind = clip_bpe._kind(c)
        assert kind == unicodedata.category(c)[0], c
    assert clip_bpe.pre_tokenize("x²½") == ["x", "²", "½"]


def test_port_bpe_needs_no_regex(bpe_path):
    """In a fresh process where ``regex`` cannot be imported, the port's
    tokenizer loads and encodes (and imports neither JAX nor regex)."""
    code = textwrap.dedent(f"""
        import sys
        sys.modules["regex"] = None
        from physicedit_torch.extensions.clip_bpe import ClipBpeTokenizer
        tok = ClipBpeTokenizer({bpe_path!r})
        ids = tok.tokenize(["it's the cup 一只猫"], 16)
        assert ids[0, 0] == tok.sot and tok.eot in ids[0]
        assert "jax" not in sys.modules and "physicedit_tpu" not in sys.modules
        print("NO_REGEX_OK", list(ids[0]))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "NO_REGEX_OK" in proc.stdout
