"""The port's readers of Orbax's storage (``utils/ocdbt.py``,
``utils/zarr.py``, ``utils/orbax.py`` and the whole-frame Zstandard
decoder of ``native/zstd.cpp``) against tensorstore and Orbax on the CPU,
and the committed JAX-written checkpoints (tests/data/orbax/, written by
scripts/make_orbax_fixtures.py) read by the JAX package and by the port
to the same digests.

tensorstore writes the stores here: zarr v2 arrays of every dtype a train
state holds (C and F order, edge chunks, both dimension separators, raw
and Zstandard chunks) in a directory and in an OCDBT store, an OCDBT store
of several B+tree levels and commits (``max_decoded_node_bytes`` and
``max_inline_value_bytes`` small), and the port's writer's arrays read
back. Every comparison is exact. Damaged data raises ValueError naming
its file.
"""

import hashlib
import importlib.util
import json
import os
import shutil

import ml_dtypes
import numpy as np
import pytest
import tensorstore as ts
import torch

from mastermetastyletransfer_tpu_torch.data import native_loader
from mastermetastyletransfer_tpu_torch.utils import orbax as torbax
from mastermetastyletransfer_tpu_torch.utils.ocdbt import OcdbtStore, crc32c
from mastermetastyletransfer_tpu_torch.utils.zarr import (
    DirectoryStore, read_array, write_array,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "data", "orbax")
DTYPES = ("<f4", "<f2", "<f8", "<i4", "<i8", "<u4", "|b1", "bfloat16",
          "|u1", "<i2", ">f4")
# (shape, chunks, order): one chunk, edge chunks, 0-d, F order
LAYOUTS = (((5, 6), (5, 6), "C"), ((5, 6), (2, 4), "C"), ((), (), "C"),
           ((7,), (3,), "C"), ((3, 4, 5), (2, 3, 2), "F"),
           ((5, 6), (2, 4), "F"))


def _values(dtype: str, shape, rng) -> np.ndarray:
    if dtype == "bfloat16":
        return rng.standard_normal(shape).astype(ml_dtypes.bfloat16)
    dt = np.dtype(dtype)
    if dt.kind == "b":
        return rng.random(shape) > 0.5
    if dt.kind == "f":
        return rng.standard_normal(shape).astype(dt)
    return rng.integers(0, 100, shape).astype(dt)


def _same(got: torch.Tensor, want: np.ndarray) -> bool:
    if want.dtype == ml_dtypes.bfloat16:
        return (got.dtype == torch.bfloat16 and np.array_equal(
            got.view(torch.int16).numpy().view(np.uint16),
            want.view(np.uint16)))
    arr = got.numpy()
    return (arr.dtype == want.dtype.newbyteorder("=")
            and arr.shape == want.shape and np.array_equal(arr, want))


def _kvstore(kind: str, path: str, **config) -> dict:
    base = {"driver": "file", "path": path}
    if kind == "directory":
        return base
    return {"driver": "ocdbt", "base": base, "config": config}


def _open(kind: str, path: str):
    return DirectoryStore(path) if kind == "directory" else OcdbtStore(path)


@pytest.mark.parametrize("kind", ["directory", "ocdbt"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_zarr_arrays_read_as_tensorstore_wrote_them(tmp_path, kind, dtype):
    """Each layout of LAYOUTS, raw and Zstandard, separators "." and "/",
    written by tensorstore's zarr TensorStore, reads back exactly, in its
    dtype (bfloat16 as torch.bfloat16)."""
    rng = np.random.default_rng(DTYPES.index(dtype))
    path = str(tmp_path / "store")
    spec = _kvstore(kind, path, max_inline_value_bytes=64)
    want = {}
    for i, (shape, chunks, order) in enumerate(LAYOUTS):
        for comp in (None, {"id": "zstd", "level": 1}):
            name = f"a{i}_{'zstd' if comp else 'raw'}"
            meta = {"shape": list(shape), "chunks": list(chunks),
                    "dtype": dtype, "order": order, "compressor": comp,
                    "fill_value": None,
                    "dimension_separator": "/" if i % 2 else "."}
            arr = _values(dtype, shape, rng)
            ts.open({"driver": "zarr", "kvstore": spec, "path": name,
                     "metadata": meta}, create=True).result().write(
                arr).result()
            want[name] = arr
    store = _open(kind, path)
    for name, arr in want.items():
        assert _same(read_array(store, name), arr), name


def test_zarr_absent_chunks_take_the_fill_value(tmp_path):
    """Chunks never written read as ``fill_value``: NaN, a number, or 0
    where it is null, as tensorstore reads them."""
    path = str(tmp_path / "fill")
    for name, fill, dtype in (("nan", "NaN", "<f4"), ("seven", 7, "<i4"),
                              ("null", None, "<f8"),
                              ("bf16_inf", "-Infinity", "bfloat16")):
        t = ts.open({"driver": "zarr", "kvstore": {"driver": "file",
                                                  "path": path},
                     "path": name, "metadata": {
                         "shape": [6], "chunks": [2], "dtype": dtype,
                         "fill_value": fill, "compressor": None}},
                    create=True).result()
        t[2:4].write(np.ones(2, t.dtype.numpy_dtype)).result()
        want = t.read().result()
        got = read_array(DirectoryStore(path), name)
        if dtype == "bfloat16":
            got, want = got.float().numpy(), want.astype(np.float32)
        else:
            got = got.numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("case", ["f32", "bf16", "i32_scalar", "empty",
                                  "bool", "f64_3d"])
def test_port_writer_reads_in_tensorstore(tmp_path, case):
    """``write_array``'s arrays read back exactly through tensorstore's
    zarr TensorStore, and through the port's reader."""
    g = torch.Generator().manual_seed(0)
    t = {"f32": torch.randn(3, 4, generator=g),
         "bf16": torch.randn(5, generator=g).to(torch.bfloat16),
         "i32_scalar": torch.tensor(7, dtype=torch.int32),
         "empty": torch.zeros(0, 3),
         "bool": torch.tensor([True, False, True]),
         "f64_3d": torch.randn(2, 3, 4, generator=g,
                               dtype=torch.float64)}[case]
    root = str(tmp_path)
    write_array(root, "x", t)
    got = ts.open({"driver": "zarr", "kvstore": {"driver": "file",
                                                "path": root},
                   "path": "x"}).result().read().result()
    if t.dtype == torch.bfloat16:
        assert got.dtype == ml_dtypes.bfloat16
        assert np.array_equal(got.view(np.uint16),
                              t.view(torch.int16).numpy().view(np.uint16))
    else:
        assert got.shape == tuple(t.shape)
        assert np.array_equal(got, t.numpy())
    back = read_array(DirectoryStore(root), "x")
    assert back.dtype == t.dtype and torch.equal(back, t)


def test_zstd_frames_without_a_content_size(tmp_path):
    """tensorstore's Zstandard chunks name no content size and carry no
    checksum: the whole-frame decoder grows its output, and refuses a
    frame that would pass its limit, a cut frame and bytes after it."""
    rng = np.random.default_rng(3)
    arr = np.concatenate([rng.standard_normal(70000).astype(np.float32),
                          np.zeros(30000, np.float32)])
    path = str(tmp_path)
    ts.open({"driver": "zarr", "kvstore": {"driver": "file", "path": path},
             "path": "z", "metadata": {
                 "shape": [arr.size], "chunks": [arr.size], "dtype": "<f4",
                 "compressor": {"id": "zstd", "level": 3}}},
            create=True).result().write(arr).result()
    with open(os.path.join(path, "z", "0"), "rb") as f:
        frame = f.read()
    descriptor = frame[4]
    assert descriptor >> 6 == 0 and not descriptor & 0x20   # no size
    assert not descriptor & 0x04                            # no checksum
    out = native_loader.decode_zstd_frame(frame, arr.nbytes)
    assert out == arr.tobytes()
    with pytest.raises(ValueError, match="limit"):
        native_loader.decode_zstd_frame(frame, arr.nbytes - 4)
    with pytest.raises(ValueError, match="ends"):
        native_loader.decode_zstd_frame(frame[:-3], arr.nbytes)
    with pytest.raises(ValueError, match="after the frame"):
        native_loader.decode_zstd_frame(frame + b"\0", arr.nbytes)
    with pytest.raises(ValueError, match="not a Zstandard frame"):
        native_loader.decode_zstd_frame(b"\0" + frame[1:], arr.nbytes)


def test_crc32c_known_value():
    """RFC 3720's check value of CRC-32C."""
    assert crc32c(b"123456789") == 0xE3069283
    assert crc32c(bytes(32)) == 0x8A9136AA


def _deep_store(path: str, rng) -> dict:
    """An OCDBT store of seven commits, nodes of at most 256 bytes,
    values inline up to 24 bytes, four versions in the manifest."""
    kv = ts.KvStore.open(_kvstore(
        "ocdbt", path, max_decoded_node_bytes=256, max_inline_value_bytes=24,
        version_tree_arity_log2=2)).result()
    want = {}
    for commit in range(6):
        with ts.Transaction() as txn:
            for _ in range(40):
                key = (f"k{commit:02d}/{rng.integers(0, 60):03d}/"
                       + "x" * int(rng.integers(0, 5)))
                val = rng.bytes(int(rng.choice([0, 5, 20, 30, 300, 5000])))
                kv.with_transaction(txn)[key] = val
                want[key] = val
    with ts.Transaction() as txn:
        for key in list(want)[:10]:
            want[key] = b"new " + key.encode()
            kv.with_transaction(txn)[key] = want[key]
    return want


def test_ocdbt_tree_of_several_levels(tmp_path):
    """Every key and value of the newest version, through interior nodes
    with key prefixes, inline values and values in data files, and a
    version tree too long for the manifest."""
    want = _deep_store(str(tmp_path), np.random.default_rng(4))
    store = OcdbtStore(str(tmp_path))
    assert store.height >= 2 and store.older_versions >= 1
    assert list(store.keys()) == sorted(want)
    assert all(store.get(k) == v for k, v in want.items())
    inline = [k for k in want if "inline value" in store.where(k)]
    assert 0 < len(inline) < len(want)
    assert store.get("absent") is None and "absent" not in store


def _flip(path: str, offset: int) -> None:
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0x10]))


def _span(where: str):
    """(file, first byte) of an ``OcdbtStore.where`` text."""
    path, rest = where.split(" [", 1)
    return path, int(rest.split(",")[0])


@pytest.mark.parametrize("part", ["manifest", "node", "inline_chunk",
                                  "chunk_frame", "cut_data_file"])
def test_damaged_store_raises_naming_the_file(tmp_path, part):
    """A flipped byte in the manifest, in a node, in a chunk held inline
    in a leaf node (each caught by the part's CRC-32C), in a chunk's
    Zstandard frame in a data file (the block header: OCDBT keeps no
    checksum of a value in a data file, and tensorstore's frames carry
    none, so a flip inside a raw block's payload reads as tensorstore
    reads it), or a data file cut short: ValueError naming the file, no
    bytes returned."""
    path = str(tmp_path / "store")
    # nodes uncompressed for the inline chunk, so that its bytes show
    spec = _kvstore("ocdbt", path, max_inline_value_bytes=64,
                    compression=None if part == "inline_chunk" else {
                        "id": "zstd"})
    arrays = {"small": np.arange(4, dtype=np.float32),
              "big": np.random.default_rng(5).standard_normal(
                  5000).astype(np.float32)}
    for name, arr in arrays.items():
        ts.open({"driver": "zarr", "kvstore": spec, "path": name,
                 "metadata": {"shape": [arr.size], "chunks": [arr.size],
                              "dtype": "<f4", "compressor": {
                                  "id": "zstd", "level": 1}}},
                create=True).result().write(arr).result()
    store = OcdbtStore(path)
    small, big = store.where("small/0"), store.where("big/0")
    assert "inline value" in small and "inline value" not in big
    if part == "manifest":
        victim = os.path.join(path, "manifest.ocdbt")
        _flip(victim, 20)
    elif part in ("node", "inline_chunk"):
        # the leaf node that holds the small chunk
        victim, start = _span(small)
        if part == "node":
            _flip(victim, start + 16)
        else:
            with open(victim, "rb") as f:
                at = f.read().find(store.get("small/0"), start)
            assert at > start
            _flip(victim, at + 8)
    else:
        victim, start = _span(big)
        if part == "chunk_frame":
            # the first block header's type bits (after the magic, the
            # frame header descriptor and the window descriptor): the
            # reserved block type
            with open(victim, "r+b") as f:
                f.seek(start + 6)
                b = f.read(1)[0]
                f.seek(start + 6)
                f.write(bytes([b | 0x06]))
        else:
            with open(victim, "r+b") as f:
                f.truncate(start + 100)
    with pytest.raises(ValueError) as err:
        s = OcdbtStore(path)
        for name in arrays:
            read_array(s, name)
    assert victim in str(err.value), str(err.value)


def _orbax_step(tmp_path, ocdbt: bool) -> str:
    import orbax.checkpoint as ocp

    tree = {"state": {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                      "step": np.int32(4),
                      "layers": [np.ones(3, np.float32),
                                 np.zeros((2, 2), np.int64)]}}
    path = str(tmp_path / ("ocdbt" if ocdbt else "leaves"))
    ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_ocdbt=ocdbt)).save(
        path, tree)
    return path


@pytest.mark.parametrize("ocdbt", [True, False])
def test_pytree_keys_from_the_metadata(tmp_path, ocdbt):
    """``read_pytree`` keys each leaf by its key tuple from ``_METADATA``
    (sequence indices as ints), in both of Orbax's layouts."""
    leaves = torbax.read_pytree(_orbax_step(tmp_path, ocdbt))
    assert set(leaves) == {("state", "w"), ("state", "step"),
                           ("state", "layers", 0), ("state", "layers", 1)}
    assert torch.equal(leaves[("state", "w")],
                       torch.arange(6, dtype=torch.float32).reshape(2, 3))
    assert leaves[("state", "step")].dtype == torch.int32
    assert int(leaves[("state", "step")]) == 4
    assert leaves[("state", "layers", 1)].dtype == torch.int64


@pytest.mark.parametrize("change", ["zarr3", "array_metadatas",
                                    "no_use_ocdbt", "compressor",
                                    "filters"])
def test_layouts_not_read_are_refused_by_name(tmp_path, change):
    path = _orbax_step(tmp_path, False)
    meta_path = os.path.join(path, "_METADATA")
    with open(meta_path) as f:
        meta = json.load(f)
    zarray = os.path.join(path, "state.w", ".zarray")
    with open(zarray) as f:
        arr = json.load(f)
    if change == "zarr3":
        meta["use_zarr3"], want = True, "use_zarr3"
    elif change == "array_metadatas":
        os.makedirs(os.path.join(path, "array_metadatas"))
        want = "array_metadatas"
    elif change == "no_use_ocdbt":
        del meta["use_ocdbt"]
        want = "use_ocdbt"
    elif change == "compressor":
        arr["compressor"], want = {"id": "blosc"}, "compressor"
    else:
        arr["filters"], want = [{"id": "delta"}], "filters"
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    with open(zarray, "w") as f:
        json.dump(arr, f)
    with pytest.raises(ValueError, match=want):
        torbax.read_pytree(path)


# ---------------------------------------------------------------------------
# the committed JAX-written checkpoints
# ---------------------------------------------------------------------------

def _digests() -> dict:
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        return json.load(f)


def _sha(t: torch.Tensor) -> str:
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()


@pytest.mark.parametrize("name", sorted(_digests()))
def test_fixture_read_by_the_port_to_its_digests(name):
    """Every array leaf of the fixture, read by the port without JAX: its
    key, dtype, shape and bytes are the digests'; the placeholders are
    None."""
    info = _digests()[name]
    leaves = torbax.read_pytree(os.path.join(FIXTURES, name,
                                             str(info["step"])))
    arrays = {k: v for k, v in leaves.items() if v is not None}
    want = {tuple(r["key"]): r for r in info["leaves"]}
    assert set(arrays) == set(want)
    for key, row in want.items():
        t = arrays[key]
        dtype = "bfloat16" if t.dtype == torch.bfloat16 else str(
            t.numpy().dtype)
        assert (dtype, list(t.shape), _sha(t)) == (
            row["dtype"], row["shape"], row["sha256"]), key
    assert any(v is None for v in leaves.values())


def _fixture_script():
    spec = importlib.util.spec_from_file_location(
        "make_orbax_fixtures", os.path.join(ROOT, "scripts",
                                            "make_orbax_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", sorted(_digests()))
def test_fixture_read_by_jax_to_its_digests(name, tmp_path):
    """The JAX package's ``restore_checkpoint`` reads the committed
    fixture to the same digests (its layout as named)."""
    script = _fixture_script()
    info = _digests()[name]
    # a copy: Orbax may write beside a checkpoint it reads
    path = str(tmp_path / name)
    shutil.copytree(os.path.join(FIXTURES, name), path)
    cfg = script.fixture_config(info["mode"])
    rows = script.leaf_digests(script.restored(path, name, cfg))
    assert rows == info["leaves"]
    step = os.path.join(path, str(info["step"]))
    assert os.path.exists(os.path.join(step, "manifest.ocdbt")) == (
        info["layout"] == "ocdbt")


class _StubLib:
    """Stands in for a kernel library: launches nothing."""

    def __getattr__(self, name):
        return lambda *args: 1 if name.endswith(
            ("smem_bytes", "per_block")) else 0


@pytest.mark.parametrize("name", sorted(_digests()))
def test_fixture_step_launch_table(name, monkeypatch):
    """One step of the fixture's mode from its restored state at its
    configuration, k = 1, the kernels on where its widths take them
    (chip_smoke.py's ``fixture_config``), with every wrapper made to see a
    card and its library a stub: its launches are chip_smoke.py's
    ``fixture_per_step``."""
    import types

    import chip_smoke
    from mastermetastyletransfer_tpu_torch.losses.vgg import (
        init_vgg19_features,
    )
    from mastermetastyletransfer_tpu_torch.models.master import (
        init_master_model,
    )
    from mastermetastyletransfer_tpu_torch.ops import block_pair as bpr
    from mastermetastyletransfer_tpu_torch.ops import ln_mlp as lm
    from mastermetastyletransfer_tpu_torch.ops import patch_embed as tpe
    from mastermetastyletransfer_tpu_torch.ops import phase_conv as pc
    from mastermetastyletransfer_tpu_torch.ops import style_block as sb
    from mastermetastyletransfer_tpu_torch.ops import window_attention as wa
    from mastermetastyletransfer_tpu_torch.ops import window_block as wb
    from mastermetastyletransfer_tpu_torch.train.state import (
        create_train_state,
    )
    from mastermetastyletransfer_tpu_torch.train.step import make_train_step
    from mastermetastyletransfer_tpu_torch.utils import checkpoint as tckpt

    info = _digests()[name]
    exp = os.path.join(FIXTURES, name)
    cfg = chip_smoke.fixture_config(exp)
    gen = torch.Generator().manual_seed(0)
    state = tckpt.restore_checkpoint(exp, create_train_state(
        init_master_model(cfg.model, gen, device="cpu"), cfg.train))
    step = make_train_step(cfg, init_vgg19_features(gen, device="cpu"),
                           device="cpu")
    lib = _StubLib()
    for mod in (wb, sb, pc, bpr, tpe, wa, lm):
        monkeypatch.setattr(mod, "_on_cuda", lambda t: True)
        monkeypatch.setattr(mod, "_lib", lambda: lib)
        for entry in mod.LAUNCHES:
            monkeypatch.setitem(mod.LAUNCHES, entry, 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    x = torch.rand((info["batch"], info["size"], info["size"], 3),
                   generator=gen)
    step(state, x, x, gen, k=1)
    assert chip_smoke.all_launches() == chip_smoke.fixture_per_step(cfg, 1)
