"""The port's YAML reader (``speechflow_torch.io.config``, no PyYAML) against the
JAX package's (PyYAML ``SafeLoader`` + ``!join``): every config of the
repository under each ``value_select``; the sections each training script
reads through its ``configs`` (which replaced the presets the scripts used to
carry); plain and quoted scalars drawn by hypothesis against PyYAML's own
resolution; ``!join``; the constructs outside the subset, each refused with its
line number; and ``yaml_dump``, which both readers read back."""

import math
from pathlib import Path

import pytest
import torch
import yaml
from hypothesis import example, given, settings
from hypothesis import strategies as st

from speechflow_torch.io.config import Config, ConfigError, value_select, yaml_dump, yaml_load
from speechflow_torch.scripts import train_prosody, train_tts, train_vocoder
from speechflow_tpu.io.config import Config as JConfig
from speechflow_tpu.io.config import yaml_load as jyaml_load

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
CONFIGS = sorted(p.name for p in (REPO / "configs").glob("*.yml"))


@pytest.mark.parametrize("value_select", ["default", "debug"])
@pytest.mark.parametrize("name", CONFIGS)
def test_every_config_reads_as_jax(name, value_select):
    text = (REPO / "configs" / name).read_text()
    assert yaml_load(text) == jyaml_load(text)
    ours = Config.create_from_file(REPO / "configs" / name, value_select=[value_select])
    theirs = JConfig.create_from_file(REPO / "configs" / name, value_select=[value_select])
    assert ours.to_dict() == theirs.to_dict()
    assert yaml.safe_load(ours.to_yaml()) == ours.to_dict() == yaml_load(ours.to_yaml())


_TTS_SECTIONS = ["experiment", "batch", "trainer", "data_loaders", "optimizer", "loss", "model"]
RECIPES = ([(train_tts, "configs/tts_model.yml", s) for s in _TTS_SECTIONS + ["data"]]
           + [(train_tts, "configs/xtts_model.yml", s) for s in _TTS_SECTIONS]
           + [(train_vocoder, "configs/vocoder_bigvgan.yml", s) for s in ("all", "data")]
           + [(train_vocoder, "configs/vocoder_model.yml", "all"),
              (train_prosody, "configs/prosody_model.yml", "all")])


@pytest.mark.parametrize("value_select", ["default", "debug"])
@pytest.mark.parametrize("script,config,section", RECIPES,
                         ids=[f"{c.split('/')[1]}-{s}" for _, c, s in RECIPES])
def test_script_configs_equal_the_jax_reading(script, config, section, value_select):
    """A training script's ``configs``: each section of its model config (or the
    whole, ``all``) and its data config (``data``) as JAX's ``Config`` reads
    them, the data root as the file writes it."""
    model_cfg, data_cfg = script.configs(value_select, config)
    if section == "data":
        ref = JConfig.create_from_file(REPO / script.DATA_CONFIG, value_select=[value_select])
        assert data_cfg == ref.to_dict()
        return
    ref = JConfig.create_from_file(REPO / config, value_select=[value_select]).to_dict()
    if section == "all":
        assert model_cfg == ref
    else:
        assert set(model_cfg) == set(ref) and model_cfg[section] == ref[section]


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return type(a) is type(b) and a == b


# characters that steer YAML 1.1's implicit resolution (numbers, signs, base 60,
# bools, nulls, dates) and a few that end a plain scalar
_PLAIN = st.text(alphabet="0123456789+-._:eEbxoOyYnNtTfFaAlLsSuU~ Zx", min_size=0,
                 max_size=14)
_TOKENS = st.sampled_from(["yes", "No", "ON", "off", "y", "n", "~", "null", "NULL", "1e-4",
                           "1.0e-4", "1.0e+4", ".5", "-.inf", ".NaN", "0x1F", "0b101", "017",
                           "08", "1_000", "190:20:30", "1:30.5", "2002-12-14",
                           "2001-12-14t21:59:43.10-05:00", "2001-12-14 21:59:43.10 Z", "+",
                           "-", ".", "1.", "_1", "0.1_0", "True", "tRUE", "=", "<<x"])


@settings(max_examples=400, deadline=None)
@given(st.one_of(_PLAIN, _TOKENS))
def test_plain_scalars_resolve_as_pyyaml(s):
    """A plain scalar in a block mapping and in a flow sequence: wherever PyYAML's
    ``SafeLoader`` reads it as a scalar, the port reads the same value and type."""
    for text, pick in ((f"k: {s}\n", lambda d: d["k"]), (f"k: [{s}, 1]\n",
                                                         lambda d: d["k"][0])):
        try:
            ref = yaml.safe_load(text)
            ref_value = pick(ref)
        except Exception:  # not a plain scalar there for PyYAML: out of scope
            continue
        if not isinstance(ref, dict) or isinstance(ref_value, (dict, list)):
            continue
        assert _same(pick(yaml_load(text)), ref_value), (text, ref_value)


@settings(max_examples=200, deadline=None)
@given(st.text(alphabet=st.characters(codec="utf-8", exclude_categories=("Cs", "Cc")),
               max_size=12))
@example("\u2028")
@example("\u2029")
def test_quoted_scalars_read_as_pyyaml(s):
    """Single-quoted (``''`` escapes a quote) and double-quoted (JSON escapes)
    scalars are strings, whatever they hold."""
    single = "'" + s.replace("'", "''") + "'"
    double = '"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'
    for q in (single, double):
        text = f"k: {q}\nl: [{q}]\n"
        assert yaml_load(text) == yaml.safe_load(text) == {"k": s, "l": [s]}


# every character at which ``str.splitlines`` breaks a line
_SPLITLINES_BREAKS = ["\n", "\r", "\r\n", "\x0b", "\x0c", "\x1c", "\x1d", "\x1e", "\x85",
                      "\u2028", "\u2029"]


@pytest.mark.parametrize("brk", _SPLITLINES_BREAKS)
@pytest.mark.parametrize("form", ["single", "double", "flow", "plain", "plain_end", "comment",
                                  "comment_quote", "line_start"])
def test_line_breaks_read_as_pyyaml(form, brk):
    """Each break of ``str.splitlines`` in a single- and a double-quoted scalar, in
    a flow sequence, inside and at the end of a plain scalar, in a comment (one
    with an apostrophe too) and before a key: where PyYAML's ``SafeLoader`` reads
    the text, the port reads the same value, or refuses it with ``ConfigError``
    (a quoted scalar over several lines is outside the subset); where PyYAML
    raises, the port raises ``ConfigError`` with the line number."""
    text = {"single": f"k: 'a{brk}b'\n", "double": f'k: "a{brk}b"\n',
            "flow": f"k: ['a{brk}b', 1]\n", "plain": f"k: a{brk}b\n",
            "plain_end": f"k: ab{brk}\n", "comment": f"k: 1 # x{brk}y\nl: 2\n",
            "comment_quote": f"k: 1 # it's{brk}l: 2\n", "line_start": f"k: 1\n{brk}l: 2\n"}[form]
    try:
        ref = yaml.safe_load(text)
    except yaml.YAMLError:
        with pytest.raises(ConfigError) as e:
            yaml_load(text)
        assert e.value.line in (1, 2)
        return
    try:
        got = yaml_load(text)
    except ConfigError as e:
        assert "several lines" in str(e) and form in ("single", "double", "flow"), (text, e)
        return
    assert got == ref, (text, got, ref)
    if brk in ("\u2028", "\u2029") and form in ("single", "double", "flow"):
        value = got["k"][0] if form == "flow" else got["k"]
        assert value == "a" + brk + "b"
    assert yaml_load(yaml_dump(got)) == yaml.safe_load(yaml_dump(got)) == got


def test_join_tag_and_value_select():
    text = ("root: !join [/data, corpora, 24khz]\nn: !join [a, 1, true]\n"
            "x: {default: 1, debug: 2, fast: 3}\nnested: {a: {default: [1], fast: [2]}}\n")
    assert yaml_load(text) == jyaml_load(text)
    assert yaml_load(text)["root"] == "/data/corpora/24khz"
    assert value_select(yaml_load(text), ["fast", "debug"]) == {
        "root": "/data/corpora/24khz", "n": "a/1/True", "x": 3, "nested": {"a": [2]}}
    assert Config.create_from_yaml(text, ["debug"])["x"] == 2
    assert Config.create_from_yaml(text)["x"] == 1


@pytest.mark.parametrize("text,line", [
    ("a: 1\nb: &anchor 2\n", 2),
    ("a: 1\nb: *alias\n", 2),
    ("a: 1\n---\nb: 2\n", 2),
    ("a: 1\nb: |\n  text\n", 2),
    ("a: 1\nb: >\n  text\n", 2),
    ("a: !!str 1\n", 1),
    ("a:\n  b: !custom x\n", 2),
    ("a: 1\n<<: {b: 2}\n", 2),
    ("a:\n\tb: 1\n", 2),
    ("a: 'open\n  quote'\n", 1),
    ("a: plain\n  continued\n", 2),
    ("? complex\n: key\n", 1),
])
def test_outside_the_subset_raises_with_its_line(text, line):
    with pytest.raises(ConfigError, match=f"^line {line}: "):
        yaml_load(text)


def test_dump_reads_back_in_both_readers():
    data = {"a": "yes", "b": "1e-4", "c": 1e-06, "d": [1, "x: y", {"e": None, "f": []}],
            "g": {}, "h": "multi\nline", "i": -0.0, "j": "", "k": " pad", "l": "#x",
            "m": [[1, 2], []], "n": True, "o": "0x1F", "p": float("inf"), "q": "it's"}
    text = yaml_dump(data)
    assert yaml.safe_load(text) == data == yaml_load(text)
