"""The port's YAML config reader and writer (utils/config.py) against
PyYAML, and its resolve_config against the JAX package's.

Tolerance: none. The reader must give exactly what yaml.safe_load gives
on every configs/*.yaml, the writer exactly what yaml.safe_dump writes
for those configs, and resolve_config the JAX version's dict and file.
"""

import glob
import math
import os
import shutil

import pytest
import yaml

from go_with_the_flows_tpu.utils import config as jax_config
from go_with_the_flows_tpu_torch.utils.config import (
    dump_config,
    load_config,
    parse_config,
    resolve_config,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))


def test_there_are_five_configs():
    assert len(CONFIGS) == 5


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_reader_matches_safe_load(path):
    with open(path) as f:
        want = yaml.safe_load(f)
    got = load_config(path)
    assert got == want
    assert [type(got[k]) for k in sorted(got)] == [type(want[k])
                                                   for k in sorted(want)]
    assert isinstance(got["jobid"], str)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_dump_round_trips_and_matches_safe_dump(path):
    config = load_config(path)
    text = dump_config(config)
    assert text == yaml.safe_dump(config)
    assert parse_config(text) == config
    assert yaml.safe_load(text) == config


def test_dump_round_trips_values_that_need_quotes():
    config = {
        "jobid": "1", "flag_text": "true", "none_text": "null",
        "tilde": "~", "spaced": "a b", "colon": "a: b", "quote": "it's",
        "float_text": "1.0", "yes_text": "yes", "empty": "", "leading": "-x",
        "tiny": 1e-06, "big": 1e20, "neg": -3.9551, "whole": 2.0,
        "inf": math.inf, "minus_inf": -math.inf, "int": -7, "zero": 0,
        "none": None, "flag_on": True, "flag_off": False,
        "items": [0.5, -1, "two"],
        "no_items": [], "path": "./results/run_1.ckpt",
    }
    text = dump_config(config)
    assert yaml.safe_load(text) == config
    assert parse_config(text) == config


@pytest.mark.parametrize("line", [
    "a: yes",          # a YAML 1.1 bool outside the subset
    "a: 012",          # octal
    "a: 0x1f",         # hex
    "a: 1e-06",        # a string to PyYAML, a float to a reader that guesses
    "a: 2001-01-01",   # a timestamp
    "a: [1, 2]",       # a flow list
    "a: {}",           # a mapping
    "  b: 1",          # nesting
    "a: b c",          # a plain string with a space
    "a: 1 # note",     # a trailing comment
    "- 1",             # a list item with no key
    "a:b",             # no space after the colon
    "a: 'x",           # an open quote
    'a: "x"',          # double quotes (the writer never emits them)
    "a: 1\na: 2",      # a duplicate key
    "on: 1",           # a key PyYAML reads as a bool
])
def test_reader_refuses_lines_outside_the_subset(line):
    with pytest.raises(ValueError):
        parse_config(line)


@pytest.mark.parametrize("key", ["on", "null", "y", "1a", "a b", 3])
def test_writer_refuses_keys_that_are_not_plain_names(key):
    with pytest.raises(ValueError):
        dump_config({key: 1})


def test_key_without_items_is_null():
    assert parse_config("a:\nb:\n- 1\n") == yaml.safe_load("a:\nb:\n- 1\n") \
        == {"a": None, "b": [1]}


def test_resolve_config_matches_jax(tmp_path):
    src = os.path.join(ROOT, "configs",
                       "config_generative_modeling_airplane.yaml")
    results = {}
    for name, module, reader in (("jax", jax_config, yaml.safe_load),
                                 ("port", None, None)):
        path = str(tmp_path / f"{name}.yaml")
        shutil.copy(src, path)
        loaded = (module.load_config(path) if module else load_config(path))
        resolve = module.resolve_config if module else resolve_config
        config = resolve(dict(loaded, path2save=str(tmp_path / "results")),
                         modelname="airplane", n_epochs=3, lr=1e-3,
                         weights_type="global_weights", jobid="7",
                         resume=True, cloud_random_rotate=False,
                         config_path=path, profile_dir=None,
                         profile_steps=2)
        with open(path) as f:
            results[name] = (config, f.read())
    (jax_dict, jax_file), (port_dict, port_file) = (results["jax"],
                                                    results["port"])
    assert port_dict == jax_dict
    assert port_dict["logging_path"] == str(tmp_path / "results"
                                            / "airplane_7")
    assert port_file == jax_file  # the logging_path written back
    assert parse_config(port_file)["logging_path"] == \
        port_dict["logging_path"]
    assert "profile_steps" not in parse_config(port_file)
