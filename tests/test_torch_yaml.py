"""PyTorch port: the YAML subset reader and writer (``utils/yaml_subset.py``)
and ``load_config`` / ``save_config``.

* The reader equals ``yaml.safe_load`` on both conf files and on scalars of
  every kind the subset takes; YAML outside the subset raises, naming the
  line.
* ``save_config`` writes block YAML that ``yaml.safe_load``, the reader and
  the JAX ``load_config`` all read back to the config's dict.
"""

import math
from pathlib import Path

import pytest
import yaml

from multi_modal_gnn_tpu.config import load_config as jax_load_config
from multi_modal_gnn_tpu_torch.config import load_config, save_config
from multi_modal_gnn_tpu_torch.utils import yaml_subset

REPO = Path(__file__).resolve().parent.parent
CONF_FILES = ["conf/config.yaml", "conf/eicu_real.yaml"]


@pytest.mark.parametrize("name", CONF_FILES)
def test_reader_equals_safe_load_on_the_conf_files(name):
    text = (REPO / name).read_text()
    assert yaml_subset.load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("name", CONF_FILES)
def test_save_config_round_trips(name, tmp_path):
    config = load_config(REPO / name)
    path = save_config(config, tmp_path / "config.yaml")
    want = config.to_dict()
    assert yaml.safe_load(path.read_text()) == want
    assert yaml_subset.load_file(path) == want
    assert load_config(path) == config
    assert jax_load_config(path).to_dict() == want


@pytest.mark.parametrize(
    "text",
    [
        "a: 1e-5", "a: 1.0e-5", "a: 0.00001", "a: .5", "a: 1.", "a: -1", "a: +3", "a: 0",
        "a: on", "a: No", "a: TRUE", "a: ~", "a:", "a: null", "a: -.inf", "a: .NaN",
        "a: 'x''y'", 'a: "tab\\t\\u00e9 \\"q\\""', "a: {b: 1, c: [x, 'y', \"z\"], d: {}}  # c",
        "a: x # c", "a: x#y", "a: 'a: b'", "a: x:y", "a: -x", "a: synthetic lab 3",
        "a: [64, 32]", "a: []", "# only\n\nb:\n  c:\n    d: [1, 2.5]\n  e: f\n",
    ],
)
def test_scalars_and_collections_equal_safe_load(text):
    got, want = yaml_subset.load(text), yaml.safe_load(text)
    value = want.get("a") if isinstance(want, dict) else None
    if isinstance(value, float) and math.isnan(value):
        assert math.isnan(got["a"])
    else:
        assert got == want


@pytest.mark.parametrize(
    "text, line",
    [
        ("a: &x 1", 1), ("a: *x", 1), ("a: !!str 1", 1), ("a: |\n  x", 1), ("a:\n  - 1", 2),
        ("a: 0755", 1), ("a: 0x1F", 1), ("a: 1_000", 1), ("a: 1:30", 1), ("a: 2001-01-01", 1),
        ("a: [1,\n 2]", 1), ("b: 1\na: 1\na: 2", 3), ("---\na: 1", 1), ("a:\n\tb: 1", 2),
        ("<<: 1", 1), ("a: [1, 2,]", 1), ("a: b: c", 1), ("a: 1\n   b: 2", 2), ("  a: 1", 1),
        ("a: 'open", 1), ("? a\n: 1", 1),
    ],
)
def test_outside_the_subset_raises_with_the_line(text, line):
    with pytest.raises(yaml_subset.YAMLSubsetError, match=f"line {line}"):
        yaml_subset.load(text)


def test_dump_writes_what_both_readers_read_back():
    data = {
        "floats": [1e-05, 2.5, 1e16, -0.0, 3.0, float("inf"), -float("inf")],
        "strings": ["x y", "it's", 'q"q', "é", "", "null", "yes", "1e-5", "#", "a: b"],
        "nested": {"empty": {}, "none": None, "flags": [True, False], "deep": {"k": 1}},
        "key with space": 1, "yes": "quoted key", "1": "numeric key",
        "nan": float("nan"),
    }
    text = yaml_subset.dump(data)
    for got in (yaml_subset.load(text), yaml.safe_load(text)):
        assert math.isnan(got.pop("nan"))
        assert got == {k: v for k, v in data.items() if k != "nan"}
    with pytest.raises(TypeError):
        yaml_subset.dump({"a": [{"b": 1}]})
