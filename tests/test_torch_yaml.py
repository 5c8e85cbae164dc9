"""The port's YAML reader (graphvite_tpu_torch/utils/yaml_lite.py) against
PyYAML's `yaml.safe_load`, which the reference's CLI reads configs with:
every shipped config, the resolver's edges (YAML 1.1), and the syntax
outside the subset, which must raise rather than be misread. Equality is
exact, types included (a float must stay a float, "5e-06" a string)."""
import glob
import math
import os

import pytest
import yaml

from graphvite_tpu_torch.utils import yaml_lite

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, REPO) for p in glob.glob(
    os.path.join(REPO, "config", "**", "*.yaml"), recursive=True))


def _same(a, b):
    """Equal values of equal types, all the way down (nan equals nan)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return (list(a) == list(b)
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def test_every_config_is_covered():
    assert len(CONFIGS) == 51


@pytest.mark.parametrize("path", CONFIGS)
def test_config_matches_safe_load(path):
    with open(os.path.join(REPO, path)) as f:
        text = f.read()
    want = yaml.safe_load(text)
    assert _same(yaml_lite.load(text), want)
    assert _same(yaml_lite.load_file(os.path.join(REPO, path)), want)


RESOLVER_CASES = [
    # YAML 1.1 floats need a dot, and a signed exponent
    "lr: 5e-06", "lr: 5e-05", "lr: 1.0e-3", "lr: 5.0e-3", "lr: 1.0e3",
    "lr: 1.5e+3", "x: .5", "x: -.inf", "x: .NaN", "x: 1_000.5",
    # ints: decimal, octal, hex, binary, base 60, underscores, signs
    "x: 017", "x: 0o17", "x: 0x1F", "x: 0b101", "x: 1:30", "x: 1:30.5",
    "x: 1_000", "x: +1", "x: -0",
    # bools in their three spellings, and what is not one
    "a: yes\nb: No\nc: ON\nd: off\ne: True\nf: FALSE\ng: y\nh: Y",
    # null: tilde, the word, and an empty value
    "a: ~\nb: null\nc: NULL\nd:\ne: Null",
    "file_name:        # FILL ME\nnext: 1",
    # quoted scalars stay strings
    "a: 'auto'\nb: \"auto\"\nc: '5e-06'\nd: 'it''s'",
    "k: it's # a comment\nl: a#b\nm: 'a # b'",
    "'quoted key': 1\n\"double\": [ 'a # b' , \"c\" ]",
    # flow sequences
    "portions: [0.1, 0.2, 0.3]\nempty: []\nnested: [[1, 2], [], [a, b,]]",
    # a list of mappings, indented and at the key's own indentation
    "evaluate:\n  - task: link prediction\n    file_name: <math.test>\n"
    "    filter_files:\n      - <math.train>\n      - <math.valid>\n"
    "  - task: node classification\n    portions: [0.2]\n",
    "evaluate:\n- task: a\n  times: 1\n- task: b\nsave:\n  file_name: x",
    "- a\n- - b\n  - c\n-\n  k: v\n- ",
    "url: http://host/path?a=1&b=2\ntime: 12:30\n",
    "", "# a comment only\n", "---\na: 1\n", "top", "a:\n  b:\n    c: 1\nd: 2",
]


@pytest.mark.parametrize("text", RESOLVER_CASES)
def test_resolver_edges_match_safe_load(text):
    assert _same(yaml_lite.load(text), yaml.safe_load(text))


def test_pyyaml_1_1_quirks_are_kept():
    """The configs' `5e-06` loads as a string (the solvers coerce with
    float()), `5.0e-3` as a float, `y` as a string."""
    got = yaml_lite.load("a: 5e-06\nb: 5.0e-3\nc: y\nd: auto")
    assert got == {"a": "5e-06", "b": 5.0e-3, "c": "y", "d": "auto"}
    assert isinstance(got["b"], float)


UNSUPPORTED = [
    ("a: &anchor 1\nb: *anchor", "anchors"),
    ("a: *alias", "aliases"),
    ("a: !!str 1", "tags"),
    ("a: |\n  text", "block scalars"),
    ("a: >\n  text", "block scalars"),
    ("a: {b: 1}", "flow mappings"),
    ("a: [b: 1]", "flow mappings"),
    ("a: 1\n---\nb: 2", "document"),
    ("a: 1\n...\n", "document"),
    ("a: plain\n  continued", "multi-line"),
    ("a: 'open\n  quote'", "multi-line quoted"),
    ('a: "tab\\there"', "escapes"),
    ("a: [1,\n  2]", "multi-line flow"),
    ("? complex\n: key", "indicator"),
    ("a: 2001-12-14", "timestamps"),
    ("<<: {}", "merge keys"),
    ("<<: 1", "merge keys"),
    ("a:\n\t- b", "tabs"),
    ("a: b: c", "mapping values"),
    ("a: - b", "indicator"),
    ("a: 1\n b: 2", "indentation"),
    ("%YAML 1.1\n---\na: 1", "directives"),
]


@pytest.mark.parametrize("text,what", UNSUPPORTED)
def test_unsupported_syntax_raises(text, what):
    with pytest.raises(yaml_lite.YAMLSubsetError, match=what):
        yaml_lite.load(text)
