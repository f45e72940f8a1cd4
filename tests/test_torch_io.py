"""The port's ``io`` (datasets, samplers, ``DataLoader``, workers) and
``framework/io`` (``save`` / ``load``) against the JAX package's, on the
CPU.

Counterparts of ``tests/test_mp_dataloader.py`` and of the ``io`` parts
of ``tests/test_io_vision.py``.  One numpy seed, set before each loader's
epoch, gives both packages' samplers the same draws, so batches compare
exactly (integers and float32 copies of the same numpy values; the JAX
package's int64 batches are int32, its x32 mode).  Saved states
round-trip exactly.
"""

import io as pyio

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import io as jio
from paddle_tpu.framework import io as jfio
from paddle_tpu_torch import io as tio
import paddle_tpu_torch as ptt


class SquareDataset:
    """Deterministic rows (module level: spawned workers pickle it)."""

    def __init__(self, n=32):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return (np.full((3,), float(i), np.float32), np.int64(i * i))


class FailingDataset(SquareDataset):
    def __getitem__(self, i):
        if i == 7:
            raise ValueError("boom at 7")
        return super().__getitem__(i)


def _sum_collate(samples):
    """Module level: spawned workers pickle the collate_fn."""
    return np.stack([s[0] for s in samples]).sum(axis=1)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x._value if hasattr(x, "_value") else x)


def _leaves(batch):
    if isinstance(batch, dict):
        return [_np(batch[k]) for k in sorted(batch)]
    if isinstance(batch, (list, tuple)):
        return [_np(b) for b in batch]
    return [_np(batch)]


def _epochs(make_jax, make_port, seed=3, epochs=2):
    """Each package's batches over ``epochs`` epochs from one numpy seed."""
    out = []
    for make in (make_jax, make_port):
        np.random.seed(seed)
        loader = make()
        out.append([_leaves(b) for _ in range(epochs) for b in loader])
    return out


def _assert_same(jax_batches, port_batches):
    assert len(jax_batches) == len(port_batches) > 0
    for jb, tb in zip(jax_batches, port_batches):
        assert len(jb) == len(tb)
        for a, b in zip(jb, tb):
            # the JAX package runs in x32: its int64 batches are int32
            assert a.dtype == b.dtype or (a.dtype, b.dtype) == (
                np.dtype(np.int32), np.dtype(np.int64))
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, False),
                                               (True, True)])
def test_batches_equal_the_jax_loader(shuffle, drop_last):
    """Shuffle off and on, ``drop_last``: the same batches in the same
    order over two epochs, and the same length."""
    ds = SquareDataset(30)
    kw = dict(batch_size=4, shuffle=shuffle, drop_last=drop_last)
    want, got = _epochs(lambda: jio.DataLoader(ds, **kw),
                        lambda: tio.DataLoader(ds, device="cpu", **kw))
    _assert_same(want, got)
    assert len(tio.DataLoader(ds, device="cpu", **kw)) == \
        len(jio.DataLoader(ds, **kw))


@pytest.mark.parametrize("sampler", ["random", "replacement", "weighted",
                                     "distributed"])
def test_samplers_draw_like_jax(sampler):
    """RandomSampler (with and without replacement), the weighted one and
    ``DistributedBatchSampler`` at 2 replicas (shuffled: RandomState of
    the epoch) give the JAX package's indices for one numpy seed."""
    ds = SquareDataset(21)

    def make(mod):
        if sampler == "random":
            return mod.BatchSampler(sampler=mod.RandomSampler(ds),
                                    batch_size=5)
        if sampler == "replacement":
            return mod.BatchSampler(sampler=mod.RandomSampler(
                ds, replacement=True, num_samples=17), batch_size=5)
        if sampler == "weighted":
            return mod.BatchSampler(sampler=mod.WeightedRandomSampler(
                np.arange(21) + 1.0, 30), batch_size=5)
        return [mod.DistributedBatchSampler(ds, 4, num_replicas=2, rank=r,
                                            shuffle=True) for r in (0, 1)]

    want, got = [], []
    for mod, out in ((jio, want), (tio, got)):
        np.random.seed(9)
        samplers = make(mod)
        for s in samplers if isinstance(samplers, list) else [samplers]:
            out.append([list(b) for _ in range(2) for b in s])
            out.append(len(s))
    assert want == got
    if sampler == "distributed":
        idx0 = {i for b in got[0] for i in b}
        idx1 = {i for b in got[2] for i in b}
        assert len(idx0 | idx1) == 21


def test_datasets_and_collate_like_jax():
    """TensorDataset, Subset, random_split, ComposeDataset, ChainDataset,
    an IterableDataset and nested dict collation: the JAX package's
    values and dtypes (int -> int64, float -> float32)."""
    a = np.arange(10, dtype=np.float32)
    jtd = jio.TensorDataset([paddle.to_tensor(a), paddle.to_tensor(a * 2)])
    ttd = tio.TensorDataset([torch.from_numpy(a), torch.from_numpy(a * 2)])
    assert [float(_np(x)) for x in jtd[3]] == [float(x) for x in ttd[3]]
    for mod in (jio, tio):
        np.random.seed(4)
        parts = mod.random_split(SquareDataset(10), [0.7, 0.3])
        if mod is jio:
            jparts = [p.indices for p in parts]
        else:
            assert [p.indices for p in parts] == jparts
    comp = tio.ComposeDataset([SquareDataset(5), SquareDataset(7)])
    assert len(comp) == 5 and len(comp[2]) == 4

    class Stream(tio.IterableDataset):
        def __iter__(self):
            for i in range(10):
                yield np.float32([i])

    batches = list(tio.DataLoader(Stream(), batch_size=4, device="cpu"))
    assert [b.shape[0] for b in batches] == [4, 4, 2]
    chain = [x for x in tio.ChainDataset([Stream(), Stream()])]
    assert len(chain) == 20

    class D:
        def __getitem__(self, i):
            return {"a": np.float32([i]), "b": i, "c": float(i)}

        def __len__(self):
            return 4

    want = next(iter(jio.DataLoader(D(), batch_size=4)))
    got = next(iter(tio.DataLoader(D(), batch_size=4, device="cpu")))
    _assert_same([_leaves(want)], [_leaves(got)])
    assert got["b"].dtype == torch.int64 and got["c"].dtype == torch.float32


@pytest.mark.parametrize("use_shm", [True, False])
def test_workers_equal_serial(use_shm):
    """Two spawned workers, through shared memory and pickled: the serial
    loader's batches in order."""
    ds = SquareDataset(32)
    serial = [_leaves(b) for b in tio.DataLoader(ds, batch_size=4,
                                                 device="cpu")]
    parallel = [_leaves(b) for b in tio.DataLoader(
        ds, batch_size=4, num_workers=2, use_shared_memory=use_shm,
        device="cpu")]
    assert len(parallel) == 8
    _assert_same(serial, parallel)


def test_worker_error_and_collate_propagate():
    """A worker's exception reaches the caller with its message; a custom
    collate runs in the workers (numpy back to tensors)."""
    with pytest.raises(RuntimeError, match="boom at 7"):
        list(tio.DataLoader(FailingDataset(16), batch_size=4, num_workers=2,
                            device="cpu"))
    out = [b.numpy() for b in tio.DataLoader(
        SquareDataset(8), batch_size=4, num_workers=2,
        collate_fn=_sum_collate, device="cpu")]
    np.testing.assert_allclose(out[0], [0.0, 3.0, 6.0, 9.0])
    np.testing.assert_allclose(out[1], [12.0, 15.0, 18.0, 21.0])


def test_custom_collate_refilling_one_buffer_yields_distinct_batches():
    """The JAX ``copy=`` rule: a collate that refills ONE buffer per batch
    still yields distinct batches (the loader snapshots its leaves),
    numpy or tensor buffers; the default collate's are fresh and not
    copied again."""
    for make in (lambda: np.zeros(4, np.float32),
                 lambda: torch.zeros(4)):
        buf = make()

        def collate(samples, buf=buf):
            for j, s in enumerate(samples):
                buf[j] = float(s[0][0])
            return buf

        got = [b.clone() if isinstance(b, torch.Tensor) else b
               for b in tio.DataLoader(SquareDataset(12), batch_size=4,
                                       collate_fn=collate, device="cpu")]
        held = list(tio.DataLoader(SquareDataset(12), batch_size=4,
                                   collate_fn=collate, device="cpu"))
        for want, b in zip(got, held):
            np.testing.assert_array_equal(_np(b), _np(want))
        assert [float(b[0]) for b in held] == [0.0, 4.0, 8.0]


def test_fetch_retries_a_transient_os_error():
    """A transient ``OSError`` in a fetch is retried and counted on
    ``dataloader.retries`` (the JAX loader's ``dataloader.fetch`` site)."""
    from paddle_tpu_torch.observability import metrics

    class Flaky(SquareDataset):
        failed = []

        def __getitem__(self, i):
            if i == 2 and not self.failed:
                self.failed.append(i)
                raise OSError("transient")
            return super().__getitem__(i)

    before = metrics.snapshot().get("dataloader.retries", {})
    out = list(tio.DataLoader(Flaky(8), batch_size=4, device="cpu"))
    assert len(out) == 2 and Flaky.failed == [2]
    after = metrics.snapshot()["dataloader.retries"]
    assert after != before


def test_distributed_sampler_needs_its_rank(monkeypatch):
    """Without ``num_replicas`` and ``rank`` the sampler takes them from
    the launcher's environment, as the JAX sampler does, batch for batch;
    an explicit argument wins."""
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "3")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    got = tio.DistributedBatchSampler(SquareDataset(10), 2, shuffle=True)
    want = jio.DistributedBatchSampler(SquareDataset(10), 2, shuffle=True)
    assert (got.nranks, got.local_rank) == (3, 1)
    assert list(got) == list(want) and len(got) == len(want)
    assert tio.DistributedBatchSampler(SquareDataset(10), 2,
                                       rank=0).local_rank == 0


def test_the_loader_runs_on_the_card_unless_told():
    """Without ``device="cpu"`` the loader resolves to the card (here: no
    CUDA, so it raises rather than move batches to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tio.DataLoader(SquareDataset(4))


# ------------------------------------------------------- framework/io

def _state(rng):
    return {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "h": rng.standard_normal((5,)).astype(np.float16),
            "ids": np.arange(6, dtype=np.int32),
            "big": np.arange(3, dtype=np.int64)}


@pytest.mark.parametrize("to_file_object", [False, True])
def test_states_cross_between_the_packages(tmp_path, to_file_object):
    """float32, float16 and integer states saved by either package load
    in the other with the same values and types; nested lists survive."""
    rng = np.random.RandomState(0)
    arrays = _state(rng)
    jstate = {k: paddle.to_tensor(v) for k, v in arrays.items()
              if v.dtype != np.int64}
    tstate = {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}
    tstate["nested"] = [torch.ones(2), {"step": 3}]

    def roundtrip(save, load, obj, name):
        if to_file_object:
            buf = pyio.BytesIO()
            save(obj, buf)
            buf.seek(0)
            return load(buf)
        path = str(tmp_path / "sub" / name)
        save(obj, path)
        return load(path)

    got = roundtrip(jfio.save, ptt.load, jstate, "j.pdparams")
    for k, v in jstate.items():
        assert isinstance(got[k], torch.Tensor)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v._value))
        assert got[k].numpy().dtype == np.asarray(v._value).dtype
    back = roundtrip(ptt.save, jfio.load, tstate, "t.pdparams")
    for k in ("w", "h", "ids"):
        np.testing.assert_array_equal(np.asarray(back[k]._value),
                                      arrays[k])
    np.testing.assert_array_equal(_np(back["big"]), arrays["big"])
    mine = roundtrip(ptt.save, ptt.load, tstate, "m.pdparams")
    for k in arrays:
        assert torch.equal(mine[k], tstate[k])
    assert torch.equal(mine["nested"][0], torch.ones(2))
    assert mine["nested"][1] == {"step": 3}
    assert np.array_equal(ptt.load(pyio.BytesIO(_bytes(ptt.save, tstate)),
                                   return_numpy=True)["w"], arrays["w"])


def _bytes(save, obj):
    buf = pyio.BytesIO()
    save(obj, buf)
    return buf.getvalue()


def test_bf16_round_trips_in_the_port():
    """bfloat16 round-trips in the port bit for bit (its 16-bit words and
    a dtype tag); a JAX bfloat16 file (an ml_dtypes array) loads as
    bfloat16 where ml_dtypes is installed; requires_grad comes back from
    the stored stop_gradient."""
    x = torch.randn(4, 3).bfloat16()
    p = torch.nn.Parameter(torch.randn(2))
    got = ptt.load(pyio.BytesIO(_bytes(ptt.save, {"x": x, "p": p})))
    assert got["x"].dtype == torch.bfloat16
    assert torch.equal(got["x"].view(torch.int16), x.view(torch.int16))
    assert got["p"].requires_grad and not got["x"].requires_grad
    j = paddle.to_tensor(x.float().numpy()).astype("bfloat16")
    got = ptt.load(pyio.BytesIO(_bytes(jfio.save, {"x": j})))
    assert got["x"].dtype == torch.bfloat16
    assert torch.equal(got["x"], x)
    with pytest.raises(ValueError, match="protocol"):
        ptt.save({}, pyio.BytesIO(), protocol=9)
