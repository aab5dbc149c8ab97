"""The port's collective-performance model against the JAX package's.

The NCCL/RoCE half (the paper's Tables II/III lottery): the DMA tier
structure of the A4 nodes, ``run_lottery``'s samples equal to JAX's bit
for bit in every (collective, size) cell, aligned and unaligned, on the
seeds of ``tests/test_netsim.py``, and that test's paper checks on the
port. Then ``NcclModel``'s pieces, ``axis_collective_seconds`` and
``random_permutation_dilation`` equal to JAX's, exactly.
"""

import pytest

from repro.topology import gcp as jgcp
from repro.topology import netsim as jnetsim
from repro.topology import tpu as jtpu
from repro_torch.topology import netsim
from repro_torch.topology.gcp import build_a4_cluster, dma_path_bw
from repro_torch.topology.tpu import build_tpu_cluster

# Paper Tables II & III: (collective, bytes) -> (aligned mean, aligned std,
#                                                unaligned mean, unaligned std)
PAPER = {
    ("all_gather", 65536): (1.29, 0.02, 1.16, 0.06),
    ("all_gather", 1 << 20): (11.42, 0.19, 8.98, 0.95),
    ("all_gather", 8 << 30): (46.59, 0.03, 29.20, 5.62),
    ("all_reduce", 65536): (1.53, 0.03, 1.21, 0.11),
    ("all_reduce", 1 << 20): (14.11, 0.13, 10.39, 2.60),
    ("all_reduce", 8 << 30): (46.93, 0.04, 29.68, 6.74),
}
# the seeds of tests/test_netsim.py: aligned runs draw seed 1, unaligned 2
SEEDS = (1, 2)


@pytest.fixture(scope="module")
def model():
    fab, nodes = build_a4_cluster(2)
    return netsim.NcclModel(fab), nodes


@pytest.fixture(scope="module")
def jax_model():
    fab, nodes = jgcp.build_a4_cluster(2)
    return jnetsim.NcclModel(fab), nodes


def test_public_names_are_jax_s():
    assert netsim.__all__ == jnetsim.__all__
    assert callable(netsim.random_permutation_dilation)


class TestDmaTiers:
    def test_tier_structure(self, model):
        m, nodes = model
        # gpu0+nic0 same switch; gpu1+nic0 same socket; gpu4+nic0 cross
        _, _, t0 = dma_path_bw(m.fabric, nodes[0].gpus[0], nodes[0].nics[0])
        _, _, t1 = dma_path_bw(m.fabric, nodes[0].gpus[1], nodes[0].nics[0])
        _, _, t2 = dma_path_bw(m.fabric, nodes[0].gpus[4], nodes[0].nics[0])
        assert (t0, t1, t2) == (0, 1, 2)

    def test_tier_counts_per_node(self, model):
        """1 aligned + 3 same-socket + 4 cross-socket — the 1-in-8 lottery."""
        m, nodes = model
        tiers = [dma_path_bw(m.fabric, g, nodes[0].nics[0])[2]
                 for g in nodes[0].gpus]
        assert sorted(tiers) == [0, 1, 1, 1, 2, 2, 2, 2]

    def test_rank_paths_equal_jax(self, model, jax_model):
        (m, nodes), (jm, jnodes) = model, jax_model
        for node, jnode in zip(nodes, jnodes):
            for nic, jnic in zip(node.nics, jnode.nics):
                for gpu, jgpu in zip(node.gpus, jnode.gpus):
                    assert m.rank_path(gpu, nic) == jm.rank_path(jgpu, jnic)


class TestLotteryEqualsJax:
    @pytest.mark.parametrize("seed", SEEDS)
    @pytest.mark.parametrize("aligned", [True, False])
    @pytest.mark.parametrize("coll,size", list(PAPER))
    def test_samples_bit_equal(self, model, jax_model, coll, size, aligned, seed):
        (m, nodes), (jm, jnodes) = model, jax_model
        r = netsim.run_lottery(m, nodes, coll, size, aligned=aligned, seed=seed)
        j = jnetsim.run_lottery(jm, jnodes, coll, size, aligned=aligned, seed=seed)
        assert len(r.samples) == 100
        assert r.samples == j.samples
        assert (r.mean, r.std) == (j.mean, j.std)

    def test_curves_and_collective_times_equal_jax(self, model, jax_model):
        (m, nodes), (jm, jnodes) = model, jax_model
        ranks = [(n.gpus[3], n.nics[0]) for n in nodes]
        jranks = [(n.gpus[3], n.nics[0]) for n in jnodes]
        for size in (1000, 65536, 300_000, 1 << 20, 1 << 27, 8 << 30, 1 << 40):
            for coll in ("all_gather", "all_reduce"):
                assert m.curves[coll](size) == jm.curves[coll](size)
                assert (m.effective_bw(size, coll, ranks)
                        == jm.effective_bw(size, coll, jranks))
                assert m.busbw(coll, size, ranks) == jm.busbw(coll, size, jranks)
            assert m.all_gather_time(size, ranks) == jm.all_gather_time(size, jranks)
            assert m.all_reduce_time(size, ranks) == jm.all_reduce_time(size, jranks)
        with pytest.raises(ValueError):
            m.busbw("gossip", 1024, ranks)

    def test_lottery_result_of(self):
        for samples in ([3.0], [1.0, 2.0, 4.5]):
            r = netsim.LotteryResult.of(samples)
            j = jnetsim.LotteryResult.of(samples)
            assert (r.mean, r.std, r.samples) == (j.mean, j.std, j.samples)


class TestPaperTables:
    @pytest.mark.parametrize("coll,size", list(PAPER))
    def test_aligned_matches_paper(self, model, coll, size):
        m, nodes = model
        r = netsim.run_lottery(m, nodes, coll, size, aligned=True, seed=1)
        want = PAPER[(coll, size)][0]
        assert abs(r.mean - want) / want < 0.02, (r.mean, want)

    @pytest.mark.parametrize("coll,size", list(PAPER))
    def test_unaligned_prediction_within_10pct(self, model, coll, size):
        m, nodes = model
        r = netsim.run_lottery(m, nodes, coll, size, aligned=False, seed=2)
        want = PAPER[(coll, size)][2]
        assert abs(r.mean - want) / want < 0.10, (r.mean, want)

    def test_variance_collapse(self, model):
        """§V.C headline: aligned collapses the std dev."""
        m, nodes = model
        a = netsim.run_lottery(m, nodes, "all_gather", 8 << 30, aligned=True, seed=1)
        u = netsim.run_lottery(m, nodes, "all_gather", 8 << 30, aligned=False, seed=2)
        assert a.std < 0.15
        assert u.std > 3.0

    def test_headline_gains(self, model):
        """+59.6% all-gather / +58.1% all-reduce at 8 GB (paper §VI)."""
        m, nodes = model
        for coll, paper_gain in [("all_gather", 59.6), ("all_reduce", 58.1)]:
            a = netsim.run_lottery(m, nodes, coll, 8 << 30, aligned=True, seed=1)
            u = netsim.run_lottery(m, nodes, coll, 8 << 30, aligned=False, seed=2)
            gain = 100 * (a.mean - u.mean) / u.mean
            assert abs(gain - paper_gain) < 10, (coll, gain)


class TestTpuRings:
    @pytest.mark.parametrize("axis_size", [1, 2, 4, 16])
    def test_axis_collective_seconds_equal_jax(self, axis_size):
        per = {"all_gather": 3.0e8, "reduce_scatter": 1.5e8, "all_reduce": 6.0e8,
               "all_to_all": 2.0e7, "collective_permute": 4.0e6}
        for bw, dmean, dmax in ((50.0, 1.0, 1), (25.0, 3.5, 8)):
            got = netsim.axis_collective_seconds(per, axis_size, bw, dmean, dmax)
            want = jnetsim.axis_collective_seconds(per, axis_size, bw, dmean, dmax)
            assert got == want
            assert (got == 0.0) == (axis_size == 1)

    @pytest.mark.parametrize("axis_size", [4, 16, 32])
    def test_random_permutation_dilation_equal_jax(self, axis_size):
        """On tests/test_planner.py's cluster (two default pods): the same
        draws, for either pod."""
        cluster = build_tpu_cluster(num_pods=2)
        jcluster = jtpu.build_tpu_cluster(num_pods=2)
        for pod, seed in ((0, 0), (1, 7)):
            got = netsim.random_permutation_dilation(cluster, pod, axis_size, seed=seed)
            want = jnetsim.random_permutation_dilation(jcluster, pod, axis_size,
                                                       seed=seed)
            assert got == want

    def test_random_permutation_expectation(self):
        """tests/test_planner.py:73 on the port: 2 x E[d] on a 16-torus."""
        mean, _ = netsim.random_permutation_dilation(build_tpu_cluster(num_pods=2),
                                                     0, 16, trials=16)
        assert 6.0 < mean < 10.0
