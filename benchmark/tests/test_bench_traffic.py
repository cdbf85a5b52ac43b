"""The inputs and traffic, made from the seed: the same seed gives the same
work, another seed the same amount of it."""

import numpy as np
import pytest

from benchmark.drivers.serve import schedule
from benchmark.drivers.train import index_rows
from benchmark.hooks import pick
from benchmark.inputs import POCKET_MAX, make_pool, request_entry

BIG = 2 ** 31 + 12345


def test_pool_is_deterministic_and_shaped():
    a, b, c = make_pool(12, BIG), make_pool(12, BIG), make_pool(12, BIG + 1)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(a["frames"], c["frames"])
    # the same mix of peptide lengths for every seed
    np.testing.assert_array_equal(a["mask"].sum(1), c["mask"].sum(1))
    assert set(a["mask"].sum(1)) == {8, 9, 10, 11}
    assert (a["pocket_mask"].sum(1) >= 20).all() and (a["pocket_mask"].sum(1) <= POCKET_MAX).all()
    assert ((a["protein_len"] >= 150) & (a["protein_len"] < 180)).all()
    q = a["frames"][..., :4][a["mask"]]
    np.testing.assert_allclose(np.linalg.norm(q, axis=-1), 1.0, atol=1e-5)


def test_request_entry_is_a_valid_serving_entry():
    from pmhc_tpu_torch.serve import validate_entry

    pool = make_pool(3, 7)
    e = validate_entry(request_entry(pool, 2))
    assert e["protein_aatype"].shape == (pool["protein_len"][2],)


@pytest.mark.parametrize("seed", [0, 17, BIG])
def test_arrivals_fixed_count_sorted_and_seeded(seed):
    s1 = schedule(seed, 3, 80.0, 20.0, 256)
    assert s1 == schedule(seed, 3, 80.0, 20.0, 256)
    assert len(s1) == 1600 and s1 != schedule(seed + 1, 3, 80.0, 20.0, 256)
    offs = [o for o, _ in s1]
    assert offs == sorted(offs) and 0.0 <= offs[0] and offs[-1] < 20.0
    gaps = np.diff(offs)
    # exponential gaps (a coefficient of variation near 1), the same set for every seed
    assert 0.85 < gaps.std() / gaps.mean() < 1.15
    other = np.diff([o for o, _ in schedule(seed + 1, 3, 80.0, 20.0, 256)])
    # n - 1 gaps between n arrivals: the sets differ in the one left after the last
    assert len(np.setdiff1d(np.round(gaps, 9), np.round(other, 9))) <= 1


def test_index_rows_epochs():
    it, again = index_rows(BIG, 64, 16), index_rows(BIG, 64, 16)
    rows = [next(it) for _ in range(8)]
    assert all(np.array_equal(r, next(again)) for r in rows)
    # each epoch is a permutation of the pool
    assert sorted(np.concatenate(rows[:4]).tolist()) == list(range(64))


def test_pick_is_seeded():
    assert pick(BIG, 1, 10, 3) == pick(BIG, 1, 10, 3)
    assert len(set(pick(BIG, 1, 10, 3))) == 3 and max(pick(BIG, 1, 10, 3)) < 10


def test_bursts_keep_the_mean_rate():
    s = schedule(BIG, 3, 80.0, 20.0, 256, burst_period_s=4.0, burst_duty=0.25)
    offs = np.array([o for o, _ in s])
    assert len(s) == 1600 and (np.mod(offs, 4.0) < 1.0 + 1e-9).all() and offs.max() < 20.0
