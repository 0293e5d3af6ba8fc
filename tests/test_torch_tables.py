"""Port parity: kernel tables and the device code table (PyTorch vs JAX)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from deciphon_tpu.ops import viterbi_pallas as vp
from deciphon_tpu.ops.costs import build_costs
from deciphon_tpu.profile import sample_profile
from deciphon_tpu.scan import scheduler as ref_sched
from deciphon_tpu.scan.sequence import Sequence, frag_codes_ending
from deciphon_tpu_torch.convert import (costs_from_arrays,
                                        sequence_from_arrays)
from deciphon_tpu_torch.ops import tables as tt
from deciphon_tpu_torch.scan.scheduler import (DeviceSeqCodes,
                                               start_codes_compute)
from deciphon_tpu_torch.workload import random_bases

# One torch thread: the plain versions run thousands of small ops, and
# several test workers with a thread pool each starve one another.
torch.set_num_threads(1)


@pytest.mark.parametrize("K", [9, 40, 150])
@pytest.mark.parametrize("mh,h3c", [(True, False), (False, True)])
def test_build_tables_bit_equal(K, mh, h3c):
    costs = build_costs(sample_profile(K + 3, K), mh, h3c)
    carried = costs_from_arrays(**vars(costs))
    table, tvec = tt.build_tables(carried)
    rt, rv = vp.build_tables(costs)
    assert table.dtype == torch.float32 and tvec.dtype == torch.float32
    assert np.array_equal(table.numpy(), rt)
    assert np.array_equal(tvec.numpy(), rv)
    # an explicit wider lane plane, as a bucket's common Kp gives it
    table, tvec = tt.build_tables(carried, 384)
    rt, rv = vp.build_tables(costs, 384)
    assert np.array_equal(table.numpy(), rt)
    assert np.array_equal(tvec.numpy(), rv)


def test_common_kp_and_stack():
    costs = [build_costs(sample_profile(s, k))
             for s, k in [(1, 9), (2, 40), (3, 150)]]
    carried = [costs_from_arrays(**vars(c)) for c in costs]
    assert tt.common_kp(carried) == vp.common_kp(costs) == 256
    assert tt.round_up(130, 128) == vp.round_up(130, 128) == 256
    tables, tvecs = tt.stack_tables(carried)
    assert tuple(tables.shape) == (3, 1364, 256)
    for i, c in enumerate(costs):
        rt, rv = vp.build_tables(c, 256)
        assert np.array_equal(tables[i].numpy(), rt)
        assert np.array_equal(tvecs[i].numpy(), rv)
    with pytest.raises(ValueError):
        tt.build_tables(carried[2], 128)


@pytest.mark.parametrize("T", [1, 2, 7, 64, 501])
def test_start_codes_match_jax_and_host(T):
    rng = np.random.default_rng(T)
    bases = rng.integers(0, 4, size=T).astype(np.int8)
    got = start_codes_compute(torch.from_numpy(bases)).numpy()
    want = np.asarray(ref_sched._start_codes_device(jnp.asarray(bases)))
    assert got.dtype == np.int32
    assert np.array_equal(got, want)  # wrap rows included
    host = vp.start_codes(frag_codes_ending(bases))
    for t in range(1, 6):
        n = max(0, T - (t - 1))
        assert (got[:n, t - 1] == host[:n, t - 1]).all()


def test_device_seq_codes_match_reference():
    rng = np.random.default_rng(5)
    seqs = [Sequence.make(i, f"s{i}", random_bases(rng, n))
            for i, n in enumerate([37, 1, 260, 90])]
    got = DeviceSeqCodes([sequence_from_arrays(**vars(s)) for s in seqs],
                         "cpu")
    want = ref_sched.DeviceSeqCodes(seqs)
    assert got.offsets == want.offsets
    assert got.total == want.total
    assert got.pad_start == want.pad_start
    assert got.dev.device.type == "cpu"
    assert np.array_equal(got.dev.numpy(), np.asarray(want.dev))
    assert got.gstart(2, 11) == want.gstart(2, 11) == 37 + 1 + 11
