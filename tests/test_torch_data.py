"""The port's Ray Data layer (``ray_tpu_torch.data``) against the JAX
package's (``ray_tpu.data``), without a runtime: the same programs, on the
same numpy inputs made from a seed, run through both packages' local
execution and give the same rows, in the same order (every program here
has a fixed order: the local shuffle is one seeded permutation in both).
The programs are the cases of ``tests/test_data.py`` and
``tests/test_data_dag.py`` whose API the port has (no pyarrow, pandas or
outside service), a few more of the same API, and ``BatchPredictor`` on
``LlamaConfig.tiny()`` with each package restoring its own checkpoint of
the same numpy weights. ``tests/test_torch_data_runtime.py`` runs the
programs again under both packages' runtimes.

Every function a program hands to a dataset is module-level: under the
port's runtime the workers import this module by name, so it imports
nothing heavy at the top (no torch, no JAX, no ``ray_tpu``).
"""

import importlib
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def packages():
    """{"jax": ray_tpu.data, "port": ray_tpu_torch.data}."""
    return {"jax": importlib.import_module("ray_tpu.data"),
            "port": importlib.import_module("ray_tpu_torch.data")}


def plain(v):
    """A program's result as plain Python (numpy scalars and arrays as
    lists), so the two packages' results compare with ``==``."""
    if isinstance(v, dict):
        return {k: plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [plain(x) for x in v]
    if isinstance(v, np.ndarray):
        return plain(v.tolist())
    if isinstance(v, np.generic):
        return v.item()
    return v


def rows(ds):
    return plain(ds.take_all())


# ------------------------------------------------------ the functions


def double_id(b):
    return {"x": b["id"] * 2}


def square_id(b):
    return {"sq": b["id"] ** 2}


def id_and_square(b):
    return {"id": b["id"], "sq": b["id"] ** 2}


def inc_v(r):
    return {"v": int(r["id"]) + 1}


def v_is_even(r):
    return r["v"] % 2 == 0


def id_is_even(r):
    return r["id"] % 2 == 0


def two_rows(r):
    return [{"y": r["x"]}, {"y": r["x"] * 10}]


def times_ten(r):
    return {"id": r["id"] * 10}


def negate(r):
    return {"id": -r["id"]}


def plus_one(r):
    return {"id": r["id"] + 1}


def plus_100(r):
    return {"id": r["id"] + 100}


def cube(r):
    return {"cube": r["id"] ** 3}


def id_square_row(r):
    return {"id": r["id"], "sq": r["id"] ** 2}


def keep_id(r):
    return {"id": r["id"]}


def keep_id_batch(b):
    return {"id": b["id"]}


def mod5_float(b):
    return {"k": b["id"] % 5, "v": b["id"].astype(np.float64)}


def mod4(b):
    return {"k": b["id"] % 4, "v": b["id"]}


def times_three(b):
    return {"v": b["id"] * 3}


def add_one_v(b):
    return {"v": b["v"] + 1}


def id_as_x(b):
    return {"x": b["id"]}


def summarize(group):
    return {"k": [int(group["k"][0])], "total": [int(group["v"].sum())]}


def group_sum(g):
    return {"k": g["k"][:1], "s": [float(sum(g["v"]))]}


def half_id(batch):
    return batch["id"] * 0.5


class AddModel:
    """A callable class: an actor-pool stage (one instance a member)."""

    def __init__(self, delta):
        self.delta = delta
        self.pid = os.getpid()

    def __call__(self, batch):
        return {"y": batch["id"] + self.delta,
                "pid": np.full(len(batch["id"]), self.pid)}


def items(n, fn):
    return [fn(i) for i in range(n)]


def kv_item(i):
    return {"k": i % 3, "v": float(i)}


def images(n=10):
    return np.random.RandomState(0).randint(0, 255, (n, 8, 8, 3),
                                            dtype=np.uint8)


# ------------------------------------------------------- the programs
#
# Each takes a package's ``data`` module and returns what is compared.


def p_range_count_take(rd):
    ds = rd.range(100)
    return ds.count(), plain(ds.take(5)), ds.num_blocks()


def p_from_items(rd):
    return rows(rd.from_items([{"a": i, "b": i * 2} for i in range(10)]))


def p_map_batches(rd):
    return plain(rd.range(32).map_batches(double_id).to_numpy())


def p_map_and_filter_rows(rd):
    return rows(rd.range(20).map(inc_v).filter(v_is_even))


def p_flat_map(rd):
    return rows(rd.from_items([{"x": 1}, {"x": 2}]).flat_map(two_rows))


def p_iter_batches(rd):
    ds = rd.range(100, override_num_blocks=7)
    return ([plain(b["id"]) for b in ds.iter_batches(batch_size=32)],
            [plain(b["id"]) for b in ds.iter_batches(batch_size=32,
                                                     drop_last=True)],
            [len(b["id"]) for b in ds.iter_batches(batch_size=None)])


def p_tensor_columns(rd):
    out = rd.from_numpy(images(), column="image").to_numpy()["image"]
    return list(out.shape), str(out.dtype), plain(out)


def p_sort_and_limit(rd):
    ds = rd.from_items([{"k": i % 5, "v": i} for i in range(20)])
    s = ds.sort("v", descending=True)
    return (plain(s.take(3)), rows(ds.sort("k")), ds.limit(7).count(),
            rows(ds.limit(7)))


def p_random_shuffle(rd):
    return rows(rd.range(50).random_shuffle(seed=42))


def p_repartition(rd):
    ds = rd.range(30).repartition(3)
    return ds.num_blocks(), ds.count(), rows(ds), [
        len(b["id"]) for b in ds.iter_batches(batch_size=None)]


def p_groupby_aggregates(rd):
    g = rd.from_items(items(12, kv_item)).groupby("k")
    return [rows(g.count()), rows(g.sum("v")), rows(g.mean("v")),
            rows(g.std("v")), rows(g.min("v")), rows(g.max("v"))]


def p_groupby_combiners(rd):
    g = rd.range(1000, override_num_blocks=8).map_batches(mod5_float) \
        .groupby("k")
    return [rows(g.sum("v")), rows(g.mean("v")), rows(g.count())]


def p_groupby_strings(rd):
    ds = rd.from_items([{"k": i % 2, "name": "abcdef"[i % 6], "v": int(i)}
                        for i in range(60)])
    out = [rows(ds.groupby("k").min("name")),
           rows(ds.groupby("k").max("name")),
           rows(ds.groupby("k").sum("v"))]
    with pytest.raises(TypeError, match="non-numeric"):
        ds.groupby("k").sum("name").take_all()
    return out


def p_map_groups(rd):
    ds = rd.range(100, override_num_blocks=5).map_batches(mod4)
    return rows(ds.groupby("k").map_groups(summarize))


def p_streaming_split(rd):
    shards = rd.range(40, override_num_blocks=8).streaming_split(4)
    return [(s.count(), plain([r["id"] for r in s.iter_rows()]))
            for s in shards]


def p_distributed_execution(rd):
    ds = rd.range(64, override_num_blocks=8).map_batches(square_id)
    return plain(ds.to_numpy())


def p_shuffle_checksum(rd):
    ds = rd.range(300, override_num_blocks=6).map_batches(times_three)
    return plain(ds.random_shuffle(seed=1).map_batches(add_one_v)
                 .to_numpy())


def p_shuffle_sort_repartition(rd):
    ds = rd.range(200, override_num_blocks=8)
    rp = ds.repartition(5)
    return (rows(ds.random_shuffle(seed=7)),
            rows(ds.sort("id", descending=True)),
            rp.num_blocks(), rows(rp))


def p_actor_pool(rd):
    out = rd.range(80, override_num_blocks=8).map_batches(
        AddModel, concurrency=2, fn_constructor_args=(100,)).to_numpy()
    return plain(out["y"]), len(set(out["pid"].tolist())) <= 2


def p_preprocessors(rd):
    pp = importlib.import_module(rd.__name__ + ".preprocessors")
    ds = rd.from_items([{"x": float(i), "y": float(i * 2),
                         "label": "ab"[i % 2], "c": "xyz"[i % 3]}
                        for i in range(10)])
    sc = pp.StandardScaler(["x"]).fit(ds)
    mm = pp.MinMaxScaler(["y"]).fit(ds)
    le = pp.LabelEncoder("label").fit(ds)
    oh = pp.OneHotEncoder(["c"]).fit(ds)
    chain = pp.Chain(pp.StandardScaler(["x"]),
                     pp.Concatenator(["x", "y"], output_column_name="feat")
                     ).fit(ds)
    one = chain.transform_batch({"x": np.asarray([0.0]),
                                 "y": np.asarray([3.0]),
                                 "label": np.asarray(["a"])})
    return [plain(p.transform(ds).to_numpy()) for p in (sc, mm, le, oh,
                                                        chain)] + [
        plain(sc.stats_), plain(le.classes_), plain(one)]


def p_union(rd):
    a = rd.from_items([{"x": i} for i in range(6)])
    b = rd.from_items([{"x": 100 + i} for i in range(4)])
    u = a.union(b)
    return rows(u), u.count(), u.num_blocks()


def p_union_multiway(rd):
    a = rd.range(5).map(times_ten)
    b = rd.range(3)
    c = rd.range(2).map(negate)
    return rows(a.union(b, c).map(plus_one))


def p_zip(rd):
    a = rd.from_items([{"x": i} for i in range(8)], override_num_blocks=4)
    b = rd.from_items([{"y": i * 2} for i in range(8)],
                      override_num_blocks=4)
    c = rd.from_items([{"x": -i} for i in range(8)], override_num_blocks=4)
    d = rd.from_items([{"x": i, "x_1": i} for i in range(8)],
                      override_num_blocks=4)
    return rows(a.zip(b)), rows(a.zip(c)), rows(d.zip(c))


def p_zip_mismatch(rd):
    a = rd.from_items([{"x": i} for i in range(8)], override_num_blocks=4)
    b = rd.from_items([{"y": i} for i in range(8)], override_num_blocks=2)
    with pytest.raises(ValueError, match="zip"):
        a.zip(b).take_all()
    return True


def p_union_zip(rd):
    a = rd.range(6, override_num_blocks=3).map(id_square_row)
    b = rd.range(6, override_num_blocks=3).map(cube)
    u = a.union(a).map(keep_id)
    return (rows(a.zip(b)), u.count(),
            sorted(plain(r["id"]) for r in u.random_shuffle(seed=3)
                   .take_all()))


def p_split_apis(rd):
    ds = rd.range(20, override_num_blocks=3).map_batches(id_as_x)
    a, b, c = ds.split_at_indices([5, 12])
    p, q, rest = ds.split_proportionately([0.25, 0.25])
    train, test = ds.train_test_split(0.3)
    train_s, test_s = ds.train_test_split(0.3, shuffle=True, seed=0)
    with pytest.raises(ValueError):
        ds.split_proportionately([0.7, 0.7])
    with pytest.raises(ValueError):
        ds.train_test_split(1.5)
    return [rows(x) for x in (a, b, c, p, q, rest, train, test, train_s,
                              test_s)] + [[rows(s) for s in ds.split(2)]]


def p_sample_unique_rename_aggregates(rd):
    ds = rd.from_items([{"x": i, "parity": i % 2} for i in range(100)],
                       override_num_blocks=4)
    renamed = ds.rename_columns({"x": "value"})
    return (rows(ds.random_sample(0.3, seed=0)), sorted(ds.unique("parity")),
            renamed.columns(), rows(renamed)[:3], ds.sum("x"), ds.min("x"),
            ds.max("x"), ds.mean("x"), ds.std("x"), ds.std("x", ddof=0))


def p_columns(rd):
    ds = rd.range(10, override_num_blocks=2).map_batches(id_and_square)
    added = ds.add_column("half", half_id)
    return (ds.columns(), rows(added), rows(added.drop_columns(["sq"])),
            rows(added.select_columns(["half", "id"])),
            rows(ds.materialize()), ds.materialize().count())


def p_stats(rd):
    ds = rd.range(500, override_num_blocks=4).map_batches(
        id_and_square).filter(id_is_even)
    n = len(ds.take_all())
    lines = [ln for ln in ds.stats().splitlines()
             if ln.startswith("Stage ")]
    return n, [ln.rsplit(",", 1)[0] for ln in lines]


def p_from_torch(rd):
    import torch
    from torch.utils.data import TensorDataset

    tds = TensorDataset(torch.arange(12).float()[:, None] * 2)
    ds = rd.from_torch(tds, override_num_blocks=3)
    return ds.count(), rows(ds)


def p_context_fields_and_unread_knobs(rd):
    """The port's DataContext has JAX's fields and defaults; the two that
    nothing reads (target_max_block_size, prefetch_batches) change no
    block in either package."""
    import dataclasses

    defaults = dataclasses.asdict(rd.DataContext())
    ctx = rd.DataContext.get_current()
    old = ctx.target_max_block_size, ctx.prefetch_batches
    ctx.target_max_block_size, ctx.prefetch_batches = 1, 0
    try:
        ds = rd.range(64, override_num_blocks=4).map_batches(double_id)
        blocks = [len(b["x"]) for b in ds.iter_batches(batch_size=None)]
        got = rows(ds)
    finally:
        ctx.target_max_block_size, ctx.prefetch_batches = old
    return defaults, blocks, got


PROGRAMS = {name[2:]: fn for name, fn in sorted(globals().items())
            if name.startswith("p_")}


def run_both(name):
    return {pkg: plain(PROGRAMS[name](rd))
            for pkg, rd in packages().items()}


# ----------------------------------------------------------- the tests


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_local_program_matches_jax(name):
    out = run_both(name)
    assert out["port"] == out["jax"]


def test_write_and_read_numpy_and_binary_files_match_jax(tmp_path):
    out = {}
    for pkg, rd in packages().items():
        root = tmp_path / pkg
        ds = rd.range(50, override_num_blocks=4).map_batches(id_as_x)
        files = ds.write_numpy(str(root / "npy"), column="x")
        back = rd.read_numpy(str(root / "npy"))
        os.makedirs(root / "bin")
        for i in range(3):
            (root / "bin" / f"f{i}.bin").write_bytes(bytes([i, 0, 0]))
        # include_paths: JAX's from_rows cannot build a block whose only
        # column is binary.
        binary = rd.read_binary_files(str(root / "bin"), include_paths=True)
        out[pkg] = ([os.path.basename(f) for f in files], rows(back),
                    [(plain(r["bytes"]), os.path.basename(r["path"]))
                     for r in binary.take_all()])
    assert out["port"] == out["jax"]
    assert out["port"][2][0] == (b"\x00\x00\x00", "f0.bin")  # NULs kept


def test_blocks_hold_numpy_columns():
    from ray_tpu_torch.data.block import (
        BlockAccessor, batch_to_format, concat_blocks, from_rows)

    rs = np.random.RandomState(0)
    vec = rs.randn(3, 4).astype(np.float32)
    block = from_rows([{"a": 1, "s": "x", "v": vec[0]},
                       {"a": 2, "b": b"\x01\x00", "v": vec[1]},
                       {"a": 3, "s": None, "v": vec[2]}])
    assert list(block) == ["a", "s", "v", "b"]
    assert block["v"].shape == (3, 4) and block["v"].dtype == np.float32
    assert block["s"].dtype == object and list(block["s"]) == ["x", None,
                                                               None]
    assert list(block["b"]) == [None, b"\x01\x00", None]
    acc = BlockAccessor(block)
    assert acc.num_rows() == 3
    assert acc.schema().names == ["a", "s", "v", "b"]
    assert acc.schema().types[2] == (np.dtype(np.float32), (4,))
    view = acc.to_numpy()["v"]
    assert not view.flags.writeable
    assert np.array_equal(BlockAccessor(acc.take([2, 0])).to_numpy()["v"],
                          vec[[2, 0]])
    both = concat_blocks([acc.slice(0, 1), acc.slice(1, 3)])
    assert np.array_equal(both["v"], vec)
    assert batch_to_format(block, "rows")[1]["a"] == 2
    with pytest.raises(ValueError, match="pandas"):
        batch_to_format(block, "pandas")


def test_iter_torch_batches_on_the_cpu_matches_jax():
    import torch

    out = {}
    for pkg, rd in packages().items():
        ds = rd.range(40, override_num_blocks=3).map_batches(id_and_square)
        kw = {"device": "cpu"} if pkg == "port" else {}
        batches = list(ds.iter_torch_batches(batch_size=16, **kw))
        out[pkg] = [{k: v.tolist() for k, v in b.items()} for b in batches]
        if pkg == "port":
            # The ingest's dtypes: int64 arrives as int32 (JAX x64 off).
            assert batches[0]["id"].dtype == torch.int32
    assert out["port"] == out["jax"]


def test_importing_the_data_package_loads_no_heavy_module():
    code = ("import sys, ray_tpu_torch.data; print(sorted(m for m in "
            "('torch', 'jax', 'ray_tpu', 'pyarrow', 'pandas', 'cloudpickle')"
            " if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout


# ---------------------------------------------------- batch inference


def jax_score(params, x):
    """[B, 2]: each row's mean log-probability of its own next tokens and
    its last position's argmax next token (the JAX model, tiny)."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import LlamaConfig
    from ray_tpu.models import forward

    logits = forward(params, x, LlamaConfig.tiny())
    logits = logits[0] if isinstance(logits, tuple) else logits
    logp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32), -1)
    tok = jnp.take_along_axis(logp, x[:, 1:, None], -1)[..., 0]
    return jnp.stack([tok.mean(-1),
                      logits[:, -1].argmax(-1).astype(jnp.float32)], -1)


def port_score(params, x):
    """The same score from the port's model, as two columns."""
    import torch

    from ray_tpu_torch.models import LlamaConfig
    from ray_tpu_torch.models.llama import forward

    logits, _ = forward(params, x, LlamaConfig.tiny())
    logp = torch.log_softmax(logits[:, :-1], -1)
    tok = logp.gather(-1, x[:, 1:, None].long())[..., 0]
    return {"logprob": tok.mean(-1), "next_token": logits[:, -1].argmax(-1)}


def tiny_weights():
    """The tiny model's weights drawn with numpy at JAX's shapes."""
    import jax

    from ray_tpu.models import LlamaConfig, init_params

    shapes = jax.eval_shape(lambda: init_params(LlamaConfig.tiny(),
                                                jax.random.PRNGKey(0)))
    rs = np.random.RandomState(0)
    return jax.tree.map(
        lambda s: (rs.standard_normal(s.shape) * 0.2).astype(s.dtype)
        if len(s.shape) > 1 else np.ones(s.shape, s.dtype), shapes)


def tiny_tokens(n=12, S=16):
    return np.random.RandomState(1).randint(0, 256, (n, S)).astype(np.int32)


def jax_tiny_predictions(tmp_path):
    """JAX's BatchPredictor over the tiny model's checkpoint, local."""
    from ray_tpu import data as jrd
    from ray_tpu.train import BatchPredictor, Checkpoint
    from ray_tpu.train.predictor import JaxPredictor

    ck = Checkpoint.from_pytree(tiny_weights(), str(tmp_path / "jax_ckpt"))
    ds = jrd.from_numpy(tiny_tokens(), column="x", override_num_blocks=3)
    out = BatchPredictor(ck, JaxPredictor, apply_fn=jax_score).predict(
        ds, concurrency=1, batch_size=4).to_numpy()["predictions"]
    return np.asarray(out)


def port_tiny_checkpoint(tmp_path):
    from ray_tpu_torch.models import LlamaConfig, params_from_numpy
    from ray_tpu_torch.train import Checkpoint

    params = params_from_numpy(tiny_weights(), LlamaConfig.tiny(), "cpu")
    return Checkpoint.from_pytree(params, str(tmp_path / "port_ckpt"))


def check_predictions(port, want):
    np.testing.assert_allclose(port["logprob"], want[:, 0], rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(port["next_token"], want[:, 1])


def test_batch_predictor_matches_jax_on_the_tiny_model(tmp_path):
    from ray_tpu_torch import data as rd
    from ray_tpu_torch.train import BatchPredictor, TorchPredictor

    want = jax_tiny_predictions(tmp_path)
    ds = rd.from_numpy(tiny_tokens(), column="x", override_num_blocks=3)
    got = BatchPredictor(port_tiny_checkpoint(tmp_path), TorchPredictor,
                         apply_fn=port_score, device="cpu").predict(
        ds, concurrency=1, batch_size=4).to_numpy()
    assert sorted(got) == ["logprob", "next_token"]
    check_predictions(got, want)
