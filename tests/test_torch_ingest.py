"""The port's ingest (``ray_tpu_torch.data.iter_device_batches``) against
the JAX package's ``Dataset.iter_jax_batches`` on the CPU: the same
dataset's numpy batches give equal values, dtypes, order and count, and
the CPU path aliases what it may and copies what it must. Values are held
equal (the dtype casts are exact or round the same way in both)."""

import numpy as np
import pytest
import torch

from ray_tpu.data.block import from_numpy_dict
from ray_tpu.data.dataset import Dataset
from ray_tpu_torch.data import iter_device_batches


def _dataset():
    """10 rows in two blocks: float64 images, int64 labels, float32
    weights, uint8 bytes."""
    rs = np.random.RandomState(0)
    cols = {"x": rs.randn(10, 3, 2), "y": rs.randint(-5, 9, (10,)),
            "w": rs.rand(10).astype(np.float32),
            "b": rs.randint(0, 255, (10, 4)).astype(np.uint8)}
    return Dataset([lambda: from_numpy_dict({k: v[:6] for k, v in
                                             cols.items()}),
                    lambda: from_numpy_dict({k: v[6:] for k, v in
                                             cols.items()})])


@pytest.mark.parametrize("batch_size,drop_last", [(4, False), (4, True),
                                                  (5, False)])
def test_batches_equal_iter_jax_batches(batch_size, drop_last):
    ds = _dataset()
    want = list(ds.iter_jax_batches(batch_size=batch_size,
                                    drop_last=drop_last))
    got = list(iter_device_batches(
        ds.iter_batches(batch_size=batch_size, batch_format="numpy",
                        drop_last=drop_last), device="cpu"))
    assert len(got) == len(want) == (2 if drop_last or batch_size == 5
                                     else 3)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            ref = np.asarray(w[k])
            assert g[k].numpy().dtype == ref.dtype, k
            np.testing.assert_array_equal(g[k].numpy(), ref)
    # float64 -> float32 and int64 -> int32, as JAX with x64 off.
    assert got[0]["x"].dtype == torch.float32
    assert got[0]["y"].dtype == torch.int32
    assert got[-1]["x"].shape[0] == (2 if batch_size == 4 and not drop_last
                                     else batch_size)


def test_dtypes_override_the_canonical_dtypes():
    ds = _dataset()
    batches = list(ds.iter_batches(batch_size=4, batch_format="numpy"))
    (one,) = iter_device_batches(batches[:1], device="cpu",
                                 dtypes=torch.float64)
    assert all(t.dtype == torch.float64 for t in one.values())
    (two,) = iter_device_batches(batches[:1], device="cpu",
                                 dtypes={"y": torch.int64,
                                         "x": torch.bfloat16})
    assert two["y"].dtype == torch.int64 and two["w"].dtype == torch.float32
    np.testing.assert_array_equal(two["y"].numpy(), batches[0]["y"])
    assert torch.equal(two["x"], torch.from_numpy(
        batches[0]["x"].astype(np.float32)).to(torch.bfloat16))


def test_cpu_path_aliases_writable_arrays_and_copies_the_rest():
    src = np.arange(12, dtype=np.float32).reshape(3, 4)
    ro = np.arange(6, dtype=np.int32)
    ro.flags.writeable = False
    strided = np.arange(20, dtype=np.float32).reshape(4, 5)[:, ::2]
    (b,) = iter_device_batches([{"a": src, "ro": ro, "s": strided}],
                               device="cpu")
    assert np.shares_memory(b["a"].numpy(), src)  # JAX's dlpack alias
    assert not np.shares_memory(b["ro"].numpy(), ro)
    assert b["ro"].numpy().flags.writeable
    np.testing.assert_array_equal(b["ro"].numpy(), ro)
    np.testing.assert_array_equal(b["s"].numpy(), strided)
    (c,) = iter_device_batches([{"a": src}], device="cpu", zero_copy=False)
    assert not np.shares_memory(c["a"].numpy(), src)
    np.testing.assert_array_equal(c["a"].numpy(), src)


def test_the_next_batch_is_put_before_the_previous_is_yielded():
    pulled = []

    def source():
        for i in range(3):
            pulled.append(i)
            yield {"i": np.array([i], dtype=np.int64)}

    it = iter_device_batches(source(), device="cpu")
    assert pulled == []  # nothing happens until the first batch is asked
    assert int(next(it)["i"][0]) == 0 and pulled == [0, 1]
    assert int(next(it)["i"][0]) == 1 and pulled == [0, 1, 2]
    assert int(next(it)["i"][0]) == 2
    with pytest.raises(StopIteration):
        next(it)


def test_ingest_to_the_card_without_one_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        iter_device_batches([{"a": np.zeros(2)}])
    with pytest.raises(ValueError, match="cuda or cpu"):
        iter_device_batches([{"a": np.zeros(2)}], device="meta")


@pytest.mark.parametrize("shape", [(1001, 2100), (3, 1 << 20), (1, 1 << 21)])
def test_large_arrays_fill_the_pinned_buffer_by_slices(shape):
    """The card's staging copy (``_fill``): an array over FILL_BYTES is
    copied by slices of its first axis on the pool's threads, cast to the
    buffer's dtype exactly as one copy would."""
    from concurrent.futures import ThreadPoolExecutor

    from ray_tpu_torch.data import ingest

    arr = np.random.RandomState(2).randn(*shape)  # float64, over 8 MB
    assert arr.nbytes >= ingest.FILL_BYTES
    host = np.empty(shape, np.float32)
    with ThreadPoolExecutor(4) as pool:
        ingest._fill(host, arr, pool)
    np.testing.assert_array_equal(host, arr.astype(np.float32))
