"""Session time zones and the filter classes: the port against the JAX
package.

``utils/tz.py``'s tables against the reference's for five zones (a
fixed one, three with DST and Lord Howe's half-hour DST); a plan under
``session_timezone`` with ``hour``, ``minute``, ``day``,
``timezone_hour``/``timezone_minute``, ``at_timezone``,
``with_timezone`` and the fixed-offset ``from_unixtime(t, hours,
minutes)`` over instants that straddle DST flips, row for row (exact);
and every filter class's mask over values with NULLs, with
``null_allowed`` off and on.
"""

import numpy as np
import pytest
import torch

from torch_tpch_data import values_in_both
from velox_tpu.exec import run_plan as jax_run_plan
from velox_tpu.plan import PlanBuilder as JaxPlanBuilder
from velox_tpu.utils.config import config as jax_config
from velox_tpu_torch.exec import run_plan as torch_run_plan
from velox_tpu_torch.plan import PlanBuilder as TorchPlanBuilder
from velox_tpu_torch.utils.config import config as torch_config

ZONES = ["UTC", "America/Los_Angeles", "Europe/London", "Asia/Kolkata",
         "Australia/Lord_Howe"]

#: 2024's DST flips: Los Angeles (Mar 10, Nov 3), London (Mar 31, Oct
#: 27) and Lord Howe (Apr 6, Oct 5), each +-2 h in 30-minute steps
FLIPS = [1710064800, 1730624400, 1711846800, 1729990800, 1712415600,
         1728142200]


def test_zone_tables_equal_the_reference():
    from velox_tpu.utils.tz import zone_tables_us as jax_tables
    from velox_tpu_torch.utils.tz import zone_source, zone_tables_us

    for z in ZONES + ["+05:30", "-08:00"]:
        got, want = zone_tables_us(z), jax_tables(z)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=z)
        assert zone_source(z)


PROJECT = ["hour(ts) AS h", "minute(ts) AS mi", "day(ts) AS d",
           "year(ts) AS y", "timezone_hour(ts) AS th",
           "timezone_minute(ts) AS tm",
           "at_timezone(ts, 'America/Los_Angeles') AS la",
           "hour(at_timezone(ts, 'Australia/Lord_Howe')) AS lh",
           "with_timezone(ts, 'Europe/London') AS wl",
           "from_unixtime(t, -8, 30) AS fu"]


@pytest.fixture(scope="module")
def instants():
    ts = np.asarray([f + d for f in FLIPS for d in range(-7200, 7201, 1800)]
                    + [0, 86_399, -1], np.int64)
    return values_in_both({"t": ts}, nulls={"t": np.arange(len(ts)) == 3})


@pytest.mark.parametrize("zone", ZONES[1:])
def test_session_zone_plan_equals_jax(instants, zone):
    jb, tb = instants

    def build(pb, batches):
        return (pb.values(batches).project(["t", "from_unixtime(t) AS ts"])
                .project(PROJECT))

    old = (jax_config.session_timezone, torch_config.session_timezone)
    jax_config.session_timezone = torch_config.session_timezone = zone
    try:
        want = jax_run_plan(build(JaxPlanBuilder(), jb).build()).to_pydict()
        got = torch_run_plan(build(TorchPlanBuilder(), tb))
    finally:
        jax_config.session_timezone, torch_config.session_timezone = old
    assert got == want
    assert len(set(got["th"]) - {None}) == (1 if zone == "Asia/Kolkata"
                                            else 2)


def test_a_zone_name_in_from_unixtime_raises_in_both(instants):
    """The reference's zone form of ``from_unixtime`` is a fixed offset
    (hours, minutes); a zone name reaches the device as a string literal
    and raises in both packages."""
    jb, tb = instants
    expr = ["from_unixtime(t, 'America/Los_Angeles') AS f"]
    with pytest.raises(RuntimeError, match="string literal"):
        jax_run_plan(JaxPlanBuilder().values(jb).project(expr).build())
    with pytest.raises(RuntimeError, match="string literal"):
        torch_run_plan(TorchPlanBuilder().values(tb).project(expr))


def _filters(pkg):
    F = pkg
    base = [F.AlwaysTrue(), F.AlwaysFalse(), F.IsNull(), F.IsNotNull(),
            F.BigintRange(lower=-3, upper=4), F.NegatedBigintRange(
                lower=-3, upper=4),
            F.BigintValuesUsingHashTable(values=(1, 5, -7)),
            F.BigintValuesUsingHashTable(values=())]
    dbl = [F.DoubleRange(lower=-1.5, upper=2.0),
           F.DoubleRange(lower=-1.5, lower_exclusive=True, upper=2.0,
                         upper_exclusive=True),
           F.DoubleRange(upper=0.25)]
    multi = [F.MultiRange(filters=(F.BigintRange(lower=-9, upper=-5),
                                   F.BigintRange(lower=6, upper=8)))]
    return base, dbl, multi


@pytest.mark.parametrize("null_allowed", [False, True])
def test_filter_masks_equal_the_reference(null_allowed):
    import dataclasses

    import jax.numpy as jnp

    import velox_tpu.types as J
    import velox_tpu_torch.types as T

    rng = np.random.default_rng(11)
    ints = rng.integers(-10, 10, 200).astype(np.int64)
    dbls = np.round(rng.normal(size=200) * 2, 2)
    dbls[:4] = [-1.5, 2.0, 0.25, np.nan]
    valid = rng.random(200) > 0.2
    for (jf, tf, vals) in [
            (j, t, v) for group, v in zip(range(3), (ints, dbls, ints))
            for j, t in zip(_filters(J)[group], _filters(T)[group])]:
        jf = dataclasses.replace(jf, null_allowed=null_allowed)
        tf = dataclasses.replace(tf, null_allowed=null_allowed)
        want = np.asarray(jf.mask(jnp.asarray(vals), jnp.asarray(valid)))
        got = tf.mask(torch.from_numpy(vals),
                      torch.from_numpy(valid)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=repr(tf))
    with pytest.raises(RuntimeError):
        T.BytesValues(values=("a",)).mask(torch.zeros(3), torch.ones(
            3, dtype=torch.bool))
