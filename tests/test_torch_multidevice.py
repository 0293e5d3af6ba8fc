"""The port's device-parallel scan (deciphon_tpu_torch/parallel/
multidevice.py) on the CPU: `devices=["cpu"] * n`, the kernels' plain
versions on every shard.

For n in {2, 3, 8} shards and every phase-1 route (the default chain +
packed tiers, DECIPHON_NO_CHAIN=1, carry segments under
DECIPHON_CHAIN_SEG=1 with the carry routed across shards, the large-K
tier with MAX_KP lowered, streamed tables at hbm_budget=1, and a custom
MultiDevicePairScorer factory over a subset of the devices), products.tsv
is byte-identical to the port's one-device scan and to the reference's
Scanner(ScanConfig(engine="jax")) on the same seeded inputs, carried
across with convert.py; every sharded wrapper is called n times for each
one-device call.
"""

import numpy as np
import pytest
import torch

from deciphon_tpu.profile import sample_profile
from deciphon_tpu.scan import pipeline as ref_pipeline
from deciphon_tpu.scan.sequence import Sequence
from deciphon_tpu_torch.convert import (frame_profile_from_arrays,
                                        sequence_from_arrays)
from deciphon_tpu_torch.ops import viterbi as vk
from deciphon_tpu_torch.ops.tables import common_kp
from deciphon_tpu_torch.parallel import multidevice as md
from deciphon_tpu_torch.scan import pipeline as tp
from deciphon_tpu_torch.scan import scheduler as ts
from deciphon_tpu_torch.workload import planted_read, random_bases

# One torch thread: the plain versions run thousands of small ops, and
# several test workers with a thread pool each starve one another.
torch.set_num_threads(1)

NS = [2, 3, 8]
ROUTES = ["default", "no_chain", "chain_seg", "large_k", "streamed",
          "factory"]
# phase-1 wrappers that a multi-device scorer splits over its shards
SHARDED = ("scores_pairs", "scores_pairs_chained", "scores_pairs_mixed",
           "scores_pairs_mixed_large", "scores_pairs_chained_carry",
           "scores_pairs_packed", "scores_pairs_packed_chained")
# ... and those that run once, on the first device
FIRST = ("scores_pairs_large", "paths_pairs")


def carried(ref_profiles, reads):
    """The reference's objects and the port's, carried across as
    arrays."""
    profiles = [frame_profile_from_arrays(**vars(p)) for p in ref_profiles]
    ref_seqs = [Sequence.make(i, f"r{i}", r) for i, r in enumerate(reads)]
    seqs = [sequence_from_arrays(**vars(s)) for s in ref_seqs]
    return (ref_profiles, ref_seqs), (profiles, seqs)


@pytest.fixture(scope="module")
def planted():
    """Three profiles (K 40 and 9 form a packed class, K 150 a plain
    bucket) and five reads, three of them planted."""
    ref_profiles = [sample_profile(140, 40), sample_profile(250, 150),
                    sample_profile(109, 9)]
    rng = np.random.default_rng(7)
    port = [frame_profile_from_arrays(**vars(p)) for p in ref_profiles]
    reads = [planted_read(rng, port[0], 300),
             planted_read(rng, port[1], 500, noise=0.01),
             random_bases(rng, 250),
             planted_read(rng, port[2], 480),
             random_bases(rng, 150)]
    return carried(ref_profiles, reads)


@pytest.fixture(scope="module")
def segmented():
    """Six small profiles of distinct K, so that their windows of the
    same reads split into different numbers of carry segments: pairs of
    later segment chunks move to other rows, and so to other shards."""
    ref_profiles = [sample_profile(300 + i, k)
                    for i, k in enumerate((9, 11, 14, 17, 20, 24))]
    port = [frame_profile_from_arrays(**vars(p)) for p in ref_profiles]
    rng = np.random.default_rng(11)
    reads = [planted_read(rng, port[0], 700, noise=0.01),
             random_bases(rng, 1300), random_bases(rng, 900)]
    return carried(ref_profiles, reads)


_JAX: dict = {}
_ONE: dict = {}


def jax_products(data, tmp_path) -> bytes:
    (profiles, seqs), _ = data
    key = id(data)
    if key not in _JAX:
        ref = ref_pipeline.Scanner(profiles,
                                   ref_pipeline.ScanConfig(engine="jax"))
        with open(ref.run(seqs, str(tmp_path / "jax")), "rb") as fp:
            _JAX[key] = fp.read()
    return _JAX[key]


def configure(route: str, monkeypatch) -> None:
    if route == "no_chain":
        monkeypatch.setenv("DECIPHON_NO_CHAIN", "1")
    if route == "chain_seg":
        # windows over 4 blocks ride carry segments (tests/test_chain.py's
        # caps for the reference)
        monkeypatch.setattr(ts.PairScorer, "CHAIN_MAX_BLK", 4)
        monkeypatch.setattr(ts.PairScorer, "NLB_FLOOR", 4)
        monkeypatch.setenv("DECIPHON_CHAIN_SEG", "1")
    if route == "large_k":
        # every bucket past 64 lanes: all profiles on the large-K tier
        monkeypatch.setattr(ts.BucketedPairScorer, "MAX_KP", 64)
        monkeypatch.setattr(ts.BucketedPairScorer, "PACK_MAX_SEG", 0)


def scorer(route: str, devices):
    """The route's scorer over `devices` (None: the one-device path)."""
    budget = 1 if route == "streamed" else None
    if route == "factory":
        def factory(costs):
            w = ts.BucketedPairScorer.plain_w(common_kp(costs))
            if devices is None:
                return ts.PairScorer(costs, "cpu", w=w)
            subset = devices[:max(2, len(devices) // 2)]
            return md.MultiDevicePairScorer(costs, devices=subset, w=w)
        return lambda costs: ts.BucketedPairScorer(costs, "cpu",
                                                   scorer_factory=factory)
    return lambda costs: ts.BucketedPairScorer(costs, "cpu",
                                               hbm_budget=budget,
                                               devices=devices)


def scan(profiles, seqs, out, spec, calls):
    calls.clear()
    sc = tp.Scanner(profiles, tp.ScanConfig(device="cpu"), scorer=spec)
    with open(sc.run(seqs, str(out)), "rb") as fp:
        return fp.read(), sc, dict(calls)


@pytest.fixture
def calls(monkeypatch):
    """Calls per kernel wrapper, looked up through the module as every
    caller does."""
    got = {}
    for name in SHARDED + FIRST:
        fn = getattr(vk, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            got[_name] = got.get(_name, 0) + 1
            return _fn(*a, **k)

        monkeypatch.setattr(vk, name, wrapped)
    return got


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("n", NS)
def test_multidevice_products_byte_identical(planted, segmented, tmp_path,
                                             monkeypatch, calls, n, route):
    data = segmented if route == "chain_seg" else planted
    profiles, seqs = data[1]
    want = jax_products(data, tmp_path)
    configure(route, monkeypatch)
    if route not in _ONE:
        _ONE[route] = scan(profiles, seqs, tmp_path / "one",
                           scorer(route, None), calls)
    one, _, one_calls = _ONE[route]
    md.reset_shard_launches()
    got, sc, multi_calls = scan(profiles, seqs, tmp_path / "multi",
                                scorer(route, ["cpu"] * n), calls)
    assert sc.metrics.survivors > 0 and sc.metrics.products > 0
    assert one == want
    assert got == one

    scorers = sc.scorer.scorers
    if route == "factory":
        assert all(isinstance(s, md.MultiDevicePairScorer) and
                   s.ndev == max(2, n // 2) for s in scorers)
        shards = max(2, n // 2)
    else:
        assert all(isinstance(s, (md.MultiDevicePairScorer,
                                  md.MultiDevicePackedScorer))
                   and s.mesh == (torch.device("cpu"),) * n
                   for s in scorers)
        shards = n
    if route == "large_k":
        assert all(s.hbm_table for s in scorers)
    if route == "streamed":
        assert sc.scorer.ledger.streamed and not sc.scorer.ledger.resident
    # each sharded call became one call a shard; B4 and phase 2 run once
    assert set(multi_calls) == set(one_calls)
    for name, k in one_calls.items():
        assert multi_calls[name] == k * (shards if name in SHARDED else 1), \
            name
    if route == "chain_seg":
        assert "scores_pairs_chained_carry" in one_calls
        assert md.ROUTED["cross"] > 0, "no carry row crossed shards"


def test_make_mesh_keeps_order_and_repeats():
    mesh = md.make_mesh(["cpu", torch.device("cpu"), "cpu"])
    assert mesh == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError):
        md.make_mesh([])


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_cuda_devices_without_a_card_raise():
    with pytest.raises(RuntimeError):
        md.make_mesh(["cuda:0", "cuda:0"])
    with pytest.raises(RuntimeError):
        md.make_mesh()
    with pytest.raises(RuntimeError):
        tp.Scanner([], tp.ScanConfig(engine="kernels-multi", device="cuda"))


def test_repeated_device_holds_one_copy(planted):
    """Two shards on one device place its tables, codes and LUT once."""
    profiles, seqs = planted[1]
    costs = tp.Scanner(profiles, tp.ScanConfig(device="cpu")).costs
    b = ts.BucketedPairScorer(costs, "cpu", devices=["cpu", "cpu"])
    codes = ts.DeviceSeqCodes(seqs, "cpu")
    b.set_device_codes(codes)
    for s in b.scorers:
        s._replica(torch.device("cpu"))
        assert list(s._replicas) == [torch.device("cpu")]
        assert s.tables is s._replicas[torch.device("cpu")][0]
    assert codes.on("cpu") is codes.dev and not codes._copies


def test_fetch_planes_reassembles_shards_in_order():
    """Parts of one plane on alternating devices come back in shard
    order, next to whole planes, one transfer a device."""
    rng = np.random.default_rng(0)
    whole = torch.from_numpy(rng.random((3, 4), np.float32))
    full = rng.random((6, 2, 2)).astype(np.float32)
    parts = [torch.from_numpy(full[i:i + 2]) for i in (0, 2, 4)]
    plane = ts.ShardedPlane(parts, [None] * 3)
    assert plane.shape == (6, 2, 2)
    got = ts.fetch_planes([whole, plane, whole])
    assert np.array_equal(got[0], whole.numpy())
    assert np.array_equal(got[1], full)
    assert np.array_equal(got[2], whole.numpy())
    assert ts.fetch_planes([]) == []


def test_kernels_multi_engine_on_cpu_is_one_device(planted, tmp_path):
    """engine="kernels-multi" splits waves over every visible card; on the
    CPU it is the one-device "kernels" scan, byte for byte."""
    assert "kernels-multi" in tp.ENGINES
    profiles, seqs = planted[1]
    out = {}
    for engine in ("kernels", "kernels-multi"):
        sc = tp.Scanner(profiles, tp.ScanConfig(device="cpu", engine=engine))
        assert isinstance(sc.scorer, ts.BucketedPairScorer)
        assert not any(isinstance(s, (md.MultiDevicePairScorer,
                                      md.MultiDevicePackedScorer))
                       for s in sc.scorer.scorers)
        with open(sc.run(seqs, str(tmp_path / engine)), "rb") as fp:
            out[engine] = fp.read()
    assert out["kernels"] == out["kernels-multi"]


def test_ledger_budget_is_the_smallest_device(monkeypatch):
    """Tables are replicated, so the smallest device's budget bounds them;
    the phase-2 bound is the first device's."""
    costs = tp.Scanner([frame_profile_from_arrays(**vars(
        sample_profile(1, 20)))], tp.ScanConfig(device="cpu")).costs
    budgets = iter([5 << 30, 3 << 30])
    monkeypatch.setattr(ts, "device_table_budget",
                        lambda d: next(budgets))
    b = ts.BucketedPairScorer(costs, "cpu", devices=["cpu", "cpu"])
    assert b.ledger.budget == 3 << 30
    assert b.path_inflight_bytes == int(ts.device_reserve("cpu")
                                        * b.PATH_INFLIGHT_SHARE)
