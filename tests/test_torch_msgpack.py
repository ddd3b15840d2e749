"""The port's msgpack decoder (deepsir_tpu_torch/utils/msgpack.py) and
checkpoint reader against `msgpack` and flax's `msgpack_restore`.

Leaf for leaf: the same paths, and every array of the same dtype, shape and
bytes; every other leaf equal and of the same type.
"""
from pathlib import Path

import msgpack
import numpy as np
import pytest
from flax import serialization
from flax.traverse_util import flatten_dict

from deepsir_tpu_torch.utils.checkpoint import read_params, resolve
from deepsir_tpu_torch.utils.msgpack import unpackb

ROOT = Path(__file__).resolve().parent.parent
CHECKPOINTS = ("logs_r3/staged_po/260817_191109_align", "logs_r3/260817_133900_align_po",
               "logs_r3/staged_po/260817_185849_feat", "logs_r3/staged_po/260817_185436_label",
               "logs_r3b/260818_115451_label_group60")


def _assert_same_tree(got, want):
    flat_got, flat_want = flatten_dict(got), flatten_dict(want)
    assert list(flat_got) == list(flat_want)
    n_arrays = 0
    for path, w in flat_want.items():
        g = flat_got[path]
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray), path
            assert (g.dtype, g.shape) == (w.dtype, w.shape), path
            assert g.tobytes() == w.tobytes(), path
            n_arrays += 1
        else:
            assert type(g) is type(w) and g == w, path
    return n_arrays


@pytest.mark.parametrize("ckpt", CHECKPOINTS)
def test_decoder_reads_every_tracked_checkpoint_as_flax_does(ckpt):
    data = resolve(ROOT / ckpt / "ckpt").read_bytes()
    got = unpackb(data)
    n_arrays = _assert_same_tree(got, serialization.msgpack_restore(data))
    assert n_arrays > 100
    leaf = next(v for v in flatten_dict(got).values() if isinstance(v, np.ndarray))
    assert leaf.flags.owndata and leaf.flags.writeable      # no alias of the file


def test_align_checkpoint_leaves():
    params = read_params(ROOT / CHECKPOINTS[0] / "ckpt")
    leaves = list(flatten_dict(params).values())
    assert len(leaves) == 340 and sum(a.size for a in leaves) == 2_746_668


def test_every_msgpack_type_decodes_as_msgpack_does():
    obj = {"nil": None, "t": True, "f": False, "fix": [0, 127, -1, -32],
           "ints": [128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
                    -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63],
           "floats": [0.5, -1e300, float("inf")], "str": ["", "a" * 31, "b" * 32,
                                                          "c" * 256, "d" * 70000, "é"],
           "bin": [b"", b"x" * 300, b"y" * 70000], "array16": list(range(20)),
           "array32": [1] * 70000, "map16": {str(i): i for i in range(20)},
           "map32": {str(i): i for i in range(70000)}, "nested": [[{"a": [[]]}]]}
    for single in (False, True):
        data = msgpack.packb(obj, use_bin_type=True, use_single_float=single)
        assert unpackb(data) == msgpack.unpackb(data, raw=False, strict_map_key=False)
    f32 = msgpack.packb(0.1, use_single_float=True)
    assert f32[0] == 0xca and unpackb(f32) == np.float32(0.1)


@pytest.mark.parametrize("size", [1, 2, 4, 8, 16, 3, 300, 70000])
def test_other_ext_types_raise_naming_the_code(size):
    data = msgpack.packb({"x": msgpack.ExtType(5, b"\0" * size)})
    with pytest.raises(ValueError, match="ext type 5"):
        unpackb(data)
    # flax's own scalar ext (3) is not in the tracked files either
    with pytest.raises(ValueError, match="ext type 3"):
        unpackb(serialization.msgpack_serialize({"s": np.float32(1.0)}))


def test_truncated_and_trailing_bytes_raise():
    data = msgpack.packb({"a": [1, 2, 3]})
    with pytest.raises(ValueError, match="truncated"):
        unpackb(data[:-1])
    with pytest.raises(ValueError, match="after the object"):
        unpackb(data + b"\x00")


def test_bare_params_file_reads_back(tmp_path):
    rng = np.random.default_rng(0)
    params = {"params": {"mlp": {"Dense_0": {"kernel": rng.normal(size=(3, 4)).astype(np.float32),
                                             "bias": np.zeros(4, np.float32)}},
                         "count": np.arange(5, dtype=np.int32).reshape(5, 1),
                         "half": np.ones((2, 2), np.float16)}}
    path = tmp_path / "model_best.msgpack"
    path.write_bytes(serialization.to_bytes(params))
    for where in (path, tmp_path):                  # a file, or its directory
        _assert_same_tree(read_params(where), params)
    state = {"state": {"params": params, "opt_state": {"0": {"mu": np.zeros(3)}},
                       "step": np.array(7, np.int32)}, "step": 7}
    path.write_bytes(serialization.to_bytes(state))
    _assert_same_tree(read_params(path), params)
