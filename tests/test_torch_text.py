"""The port's text path against the JAX package (CPU): text normalization,
the alphabet and text processor, the char fallback, the linguistic / LM /
XPBERT features of raw text, SSML, padding, and ``TTSCollate`` ->
``TTSBatchProcessor``. Strings and token ids must be equal; float features
within ``FEAT_TOL``; collated batches equal."""

import dataclasses

import numpy as np
import pytest
import torch

from speechflow_torch.data.collate import TTSCollate
from speechflow_torch.data.core.components import DataPipeline
from speechflow_torch.data.core.datasample import TTSDataSample
from speechflow_torch.data.processors import ling, ssml, text, text_norm
from speechflow_torch.models.tts.batch_processor import TTSBatchProcessor
from speechflow_torch.utils.pad import stack_and_pad
from tests.torch_parity import n

torch.set_num_threads(1)
FEAT_TOL = 1e-7

EN = [
    "On June 3rd, 1998 the 2nd and 11th runners finished.",
    "It cost $12.50, or £3 and €1.01 -- about 45% of 2,000,000.",
    "Meet at 3:05, 12:00 or 7:30; Dr. Smith, Mr. Brown and Mrs. Lee came.",
    "The 1990s and 2005 and 1066 and 1900 and 2199 were years; -42 is negative.",
    "St. Mark lives on Main St. near the U.S.A. border, e.g. in 21st-century towns etc.",
    "Call 1234567 or 3.14159 now, i.e. before 10 p.m. on the 22nd.",
    "Numbers 0 1 19 20 99 100 101 999 1000 1001 1000000 123456789012345.",
]
RU = [
    "В 1998 г. было 21 процент, т.е. 5% и 11%.",
    "Цена 1 руб. и 2 коп., 1002 человека и 3000000 рублей и т.д.",
    "У нас 22 дома, 101 окно, 1000001 звезда, -7 градусов, 2,5 литра и т.п.",
]


@pytest.mark.parametrize("lang,s", [("EN", s) for s in EN] + [("RU", s) for s in RU])
def test_normalize_text(lang, s):
    from speechflow_tpu.data.processors.text_norm import normalize_text

    out = text_norm.normalize_text(s, lang)
    assert out == normalize_text(s, lang) and out != s


@pytest.mark.parametrize("num", [0, 7, 13, 40, 99, 105, 1000, 2021, 10 ** 6 + 3, 999999999,
                                 -15])
def test_number_readers(num):
    from speechflow_tpu.data.processors import text_norm as J

    assert text_norm.en_number_to_words(num) == J.en_number_to_words(num)
    assert text_norm.ru_number_to_words(num) == J.ru_number_to_words(num)


def test_alphabet_processor_and_char_fallback():
    from speechflow_tpu.data.processors import text as J

    syms = ["b", "a", "<SIL>", "c", "a", "x"]
    a, ja = text.Alphabet(syms), J.Alphabet(syms)
    assert a.symbols == ja.symbols and len(a) == len(ja) and "c" in a
    assert text.Alphabet.from_dict(ja.to_dict()).symbols == ja.symbols
    toks = ["a", "<SIL>", "zz", "", None, "undefined_sil", "x"]
    np.testing.assert_array_equal(a.encode(toks[:3] + ["x"]), ja.encode(toks[:3] + ["x"]))
    assert a.decode([0, 5, 7]) == ja.decode([0, 5, 7])
    for service in (True, False):
        p = text.TTSTextProcessor(a, add_service_tokens=service)
        jp = J.TTSTextProcessor(ja, add_service_tokens=service)
        np.testing.assert_array_equal(p.encode_phonemes(toks), jp.encode_phonemes(toks))
        for s in EN[:3] + RU[:1]:
            np.testing.assert_array_equal(p.encode_text(s), jp.encode_text(s))
        ds, jds = p(TTSDataSample(text="a cab.", lang="EN")), jp(J.TTSDataSample(text="a cab."))
        np.testing.assert_array_equal(ds.transcription, jds.transcription)
        assert ds.transform_params == jds.transform_params
    for s, lang in [(s, "EN") for s in EN] + [(s, "RU") for s in RU]:
        assert text.TextParserHook()(s, lang) == J.TextParserHook()(s, lang)


def _words():
    return ("The quick, brown fox jumped over 2 lazy dogs! Was it really "
            "happening? — Yes; \"Quietly\" (said) Mary: the nationalization of hopeful "
            "things is endless.").split()


@pytest.mark.parametrize("intonation", [".", "?", "!", "x"])
def test_word_ling_features(intonation):
    from speechflow_tpu.data.processors import ling as J

    words = _words()
    assert ling.LING_FEAT_DIM == J.LING_FEAT_DIM == 56
    tagger, jtagger = ling.RuleBasedTagger(), J.RuleBasedTagger()
    assert [tagger(w) for w in words] == [jtagger(w) for w in words]
    a = ling.word_ling_features(words, intonation=intonation)
    b = J.word_ling_features(words, intonation=intonation)
    np.testing.assert_allclose(a, b, atol=FEAT_TOL, rtol=0)
    # with parser tiers, as a caller may give them
    kw = dict(pos_tags=["DET", "ADJ"] + ["NOUN"] * (len(words) - 2),
              syntax_rels=["det", "acl:relcl", "nsubj"] + ["weird"] * (len(words) - 3),
              word_ids=[str(i) for i in range(len(words))],
              head_ids=["2"] * 5 + ["0"] * (len(words) - 5),
              emphasis_labels=["accent", "none"] * (len(words) // 2))
    np.testing.assert_allclose(ling.word_ling_features(words, **kw),
                               J.word_ling_features(words, **kw), atol=FEAT_TOL, rtol=0)
    # spread over phonemes, and ling_feat_from_text
    word_map = np.asarray([-1, 0, 0, 1, -1, 2, 2, 2, 3, -1])
    phs = ["<SIL>", "t", "h", "q", "<SIL>", "b", "r", "o", "f", "<SIL>"]
    np.testing.assert_allclose(ling._expand(a, word_map, phs, {1, 3}),
                               J._expand(b, word_map, phs, {1, 3}), atol=FEAT_TOL, rtol=0)
    counts = [len(w) for w in words]
    for service in (True, False):
        np.testing.assert_allclose(
            ling.ling_feat_from_text(words + ["<SIL>"], counts + [1], service, intonation),
            J.ling_feat_from_text(words + ["<SIL>"], counts + [1], service, intonation),
            atol=FEAT_TOL, rtol=0)


def test_lm_and_xpbert_features():
    from speechflow_tpu.data.processors import ling as J
    from speechflow_tpu.data.processors.text import TTSDataSample as JDS

    np.testing.assert_array_equal(ling._LM_PROJ, J._LM_PROJ)
    words = _words() + ["", "ÄÖ", "<SIL>"]
    np.testing.assert_allclose(ling.lm_feat_for_words(words), J.lm_feat_for_words(words),
                               atol=FEAT_TOL, rtol=0)
    phs = ["<SIL>", "HH", "AH0", "L", "OW1", "<SIL>", "w", "ɜ", "<SIL>"]
    for n_tokens in (len(phs) + 2, len(phs)):
        tr = np.zeros(n_tokens, np.int32)
        a = ling.add_xpbert_feat(TTSDataSample(phonemes=phs, transcription=tr))
        b = J.add_xpbert_feat(JDS(phonemes=phs, transcription=tr))
        np.testing.assert_allclose(a.xpbert_feat, b.xpbert_feat, atol=FEAT_TOL, rtol=0)
    assert ling.add_xpbert_feat(TTSDataSample()).xpbert_feat is None
    # a WordLM model_ckpt is read (tests/test_torch_prosody.py holds it against JAX's):
    # a missing one raises instead of falling back to the hashed features
    with pytest.raises(FileNotFoundError):
        ling.lm_feat_for_words(["a"], model_ckpt="no_such_word_lm.pkl")


SSML = [
    'hello <prosody rate="x-slow" pitch="+20%">big world</prosody> again',
    '<prosody volume="loud" rate="0.5">one</prosody> two <prosody pitch="x-low" '
    'rate="fast" volume="-10%">three four</prosody> <prosody pitch="oops">five</prosody>',
    "no spans at all.",
    '<prosody rate="slow">\nmulti\nline</prosody>',
]


@pytest.mark.parametrize("s", SSML)
def test_ssml(s):
    from speechflow_tpu.data.processors import ssml as J
    from speechflow_tpu.data.processors.text import TTSDataSample as JDS

    plain, words = ssml.parse_ssml(s)
    assert (plain, words) == J.parse_ssml(s)
    rng = np.random.default_rng(len(s))
    wl = rng.integers(1, 4, len(words)).astype(np.int32)
    tr = np.zeros(int(wl.sum()), np.int32)
    a = ssml.apply_ssml_modifiers(TTSDataSample(transcription=tr, word_lengths=wl,
                                                additional={"ssml": words}))
    b = J.apply_ssml_modifiers(JDS(transcription=tr, word_lengths=wl,
                                   additional={"ssml": words}))
    assert a.additional.keys() == b.additional.keys()
    for k in ("pitch_modifier", "volume_modifier", "rate_modifier"):
        np.testing.assert_array_equal(a.additional[k], b.additional[k])
        assert a.additional[k].dtype == np.float32


@pytest.mark.parametrize("kind", ["1d-int", "2d-float"])
def test_stack_and_pad(rng, kind):
    from speechflow_tpu.utils.pad import stack_and_pad as J

    shape = (lambda m: (m,)) if kind == "1d-int" else (lambda m: (m, 3))
    arrays = [rng.normal(size=shape(m)).astype(np.float32) for m in (5, 17, 1)]
    if kind == "1d-int":
        arrays = [a.astype(np.int32) for a in arrays]
    for kw in (dict(multiple=16), dict(target_len=9, pad_value=-1), dict(pad_value=1.0)):
        (a, la), (b, lb) = stack_and_pad(arrays, **kw), J(arrays, **kw)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)
        assert a.dtype == b.dtype


def _samples(rng, cls, with_mods: bool):
    out = []
    for i, m in enumerate((7, 19, 3)):
        ds = cls(text="x", lang="EN", speaker_id=i, lang_id=i % 2,
                 transcription=rng.integers(1, 30, m).astype(np.int32),
                 ling_feat=rng.normal(size=(m, 56)).astype(np.float32),
                 lm_feat=rng.normal(size=(m, 32)).astype(np.float32),
                 xpbert_feat=rng.normal(size=(m, 32)).astype(np.float32),
                 prosody=rng.integers(-1, 5, m).astype(np.int32),
                 speaker_emb=rng.normal(size=8).astype(np.float32))
        if with_mods:
            ds.additional.update({k: rng.uniform(0.5, 2, m).astype(np.float32) for k in
                                  ("pitch_modifier", "volume_modifier", "rate_modifier")})
        out.append(ds)
    return out


@pytest.mark.parametrize("with_mods", [True, False])
@pytest.mark.parametrize("multiple", [16, 128])
def test_collate_and_batch_processor(with_mods, multiple):
    from speechflow_tpu.data.collate import TTSCollate as JC
    from speechflow_tpu.data.core.datasample import TTSDataSample as JDS
    from speechflow_tpu.models.tts.batch_processor import TTSBatchProcessor as JB

    ours = _samples(np.random.default_rng(3), TTSDataSample, with_mods)
    theirs = _samples(np.random.default_rng(3), JDS, with_mods)
    c = TTSCollate(token_multiple=multiple)(ours)
    jc = JC(token_multiple=multiple)(theirs)
    (inputs, _), (ref, _) = TTSBatchProcessor()(c), JB()(jc)
    checked = 0
    for f in dataclasses.fields(inputs):
        ours_v, ref_v = getattr(inputs, f.name), getattr(ref, f.name, None)
        assert (ours_v is None) == (ref_v is None), f.name
        if isinstance(ref_v, int):  # a setting (pad_id), not a batch field
            assert ours_v == ref_v, f.name
        elif ours_v is not None:
            assert isinstance(ours_v, torch.Tensor)
            np.testing.assert_array_equal(n(ours_v), np.asarray(ref_v), err_msg=f.name)
            assert ours_v.numpy().dtype == np.asarray(ref_v).dtype, f.name
            checked += 1
    assert checked == 9 + (3 if with_mods else 0)  # every field the samples fill
    assert inputs.transcription.shape[1] == -(-19 // multiple) * multiple  # longest: 19


def test_collate_gives_plain_samples_neutral_modifiers():
    """A batch that mixes SSML and plain samples keeps the SSML rows'
    modifiers and gives the plain rows 1.0 (the JAX collate drops them for
    the whole batch: ROADMAP §3)."""
    rng = np.random.default_rng(5)
    samples = _samples(rng, TTSDataSample, with_mods=True)
    mods = {k: samples[1].additional.pop(k) for k in list(samples[1].additional)}
    c = TTSCollate(token_multiple=16)(samples)
    for key, row in mods.items():
        got = c.additional[key]
        assert got.shape == (3, 32) and got.dtype == np.float32
        np.testing.assert_array_equal(got[1], np.ones(32, np.float32))
        np.testing.assert_array_equal(got[0, :7], samples[0].additional[key])
        np.testing.assert_array_equal(got[0, 7:], 1.0)
        assert not np.array_equal(got[1, :19], row)
    inputs, _ = TTSBatchProcessor()(c)
    np.testing.assert_array_equal(n(inputs.rate_modifier), c.additional["rate_modifier"])


def test_pipeline_rejects_unported_handlers():
    """Every handler of the JAX registry is ported (``spectral_flatness`` too); a
    name in neither registry raises ``KeyError`` with it, as in JAX, unless it is
    ignored; an unported collate raises ``NotImplementedError``."""
    info = {"config": {"preproc": {"pipe": ["text_to_transcription", "spectral_centroid",
                                            "add_xpbert_feat"]},
                       "collate": {"type": "TTSCollate", "token_multiple": 8}},
            "subsets": ["train"], "alphabet": text.Alphabet(["a"]).to_dict()}
    with pytest.raises(KeyError, match="spectral_centroid"):
        DataPipeline.from_info(info)
    dp = DataPipeline.from_info(info, ignored_handlers={"spectral_centroid"})
    assert dp.handler_names == ["text_to_transcription", "add_xpbert_feat"]
    assert dp.collate_fn.token_multiple == 8
    info["config"]["preproc"]["pipe"][1] = "spectral_flatness"
    assert DataPipeline.from_info(info).handler_names[1] == "spectral_flatness"
    info["config"]["collate"]["type"] = "VideoCollate"
    with pytest.raises(NotImplementedError, match="VideoCollate"):
        DataPipeline.from_info(info, ignored_handlers={"spectral_flatness"})
