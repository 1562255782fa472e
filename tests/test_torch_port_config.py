"""The port's config reader and writer (``mixdq_tpu_torch/utils/config.py``,
no YAML library) against PyYAML's ``safe_load``: every config of the repo
reads as ``safe_load`` reads it, ``save_config`` writes what ``safe_load``
reads back equal, and constructs outside the subset raise with the file
and line."""

import glob
import math
import os

import pytest

pytest.importorskip("torch")
yaml = pytest.importorskip("yaml")

from mixdq_tpu_torch.utils import config  # noqa: E402

REPO = os.path.join(os.path.dirname(__file__), "..")
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))
#: the mixed-precision files: flat bit maps and layer lists, and the
#: sensitivity logs (block lists at their key's indent, as PyYAML writes)
MP_FILES = sorted(
    p for p in glob.glob(os.path.join(REPO, "configs", "mp", "**", "*.yaml"),
                         recursive=True)
    if os.path.basename(p) != "validation.yaml")


def _id(p):
    return os.path.relpath(p, REPO)


@pytest.mark.parametrize("path", CONFIGS, ids=_id)
def test_config_reads_as_safe_load(path):
    want = yaml.safe_load(open(path))
    got = config.load_config(path)
    assert isinstance(got, config.Config) and got == want
    assert got.model.family == want["model"]["family"]
    assert got.quant.weight.get("n_bits") == want["quant"]["weight"]["n_bits"]


@pytest.mark.parametrize("path", MP_FILES, ids=_id)
def test_mp_file_reads_as_safe_load(path):
    assert config.loads(open(path).read(), path) == yaml.safe_load(open(path))


@pytest.mark.parametrize("path", CONFIGS, ids=_id)
def test_save_config_round_trips(path, tmp_path):
    cfg = config.merge(config.load_config(path),
                       {"calib_data": {"path": str(tmp_path / "c.npz")},
                        "extra": {"neg": -3, "tiny": 1e-7, "big": 1.5e20,
                                  "inf": math.inf, "bools": [True, False],
                                  "s": ["1e-5", "true", "null", "a: b",
                                        "x #y", "it's", "", "3", "a,b"]}})
    out = str(tmp_path / "c.yaml")
    config.save_config(cfg, out)
    assert yaml.safe_load(open(out)) == cfg
    assert config.load_config(out) == cfg


@pytest.mark.parametrize("text,line", [
    ("a: [[1, 2], 3]\n", 1),            # nested flow list
    ("a:\n- - 1\n", 2),                 # nested block list
    ("a: &x 1\nb: *x\n", 1),            # anchor
    ("a: 1\nb: *x\n", 2),               # alias
    ("a: {b: 1}\n", 1),                 # flow map
    ("a: !!str 1\n", 1),                # tag
    ("a: |\n  text\n", 1),              # block scalar
    ("---\na: 1\n", 1),                 # document marker
    ("a: yes\n", 1),                    # YAML 1.1 boolean
    ("a: 0x1f\n", 1),                   # hex int
    ("a:\n  - b: 1\n", 2),              # map inside a list
    ("a: 1\n\tb: 2\n", 2),              # tab indent
    ("a: 1\na: 2\n", 2),                # duplicate key
])
def test_outside_the_subset_raises(text, line, tmp_path):
    p = tmp_path / "bad.yaml"
    p.write_text(text)
    with pytest.raises(ValueError, match=rf"bad\.yaml:{line}:"):
        config.load_config(str(p))


def test_config_attribute_access_and_merge():
    c = config.Config({"a": {"b": 1}, "l": [1, 2]})
    assert c.a.b == 1 and c.get("z", 5) == 5 and c.a.get("b") == 1
    c.x = 3
    assert c["x"] == 3
    with pytest.raises(AttributeError):
        c.missing
    m = config.merge(c, {"a": {"c": 2}, "l": [3]})
    assert m == {"a": {"b": 1, "c": 2}, "l": [3], "x": 3}
    assert c.a == {"b": 1}  # the base stays as it was
