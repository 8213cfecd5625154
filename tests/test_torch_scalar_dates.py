"""The date and timestamp functions of the port's scalar surface against
the JAX package, on one small hand-made table with NULLs and calendar
edges (month ends, leap days, ISO week 53 and week 1 across a year end,
dates and timestamps before 1970 with fractional seconds): every date
part over DATE and over TIMESTAMP, the time-of-day parts, every unit of
``date_trunc``, ``date_add`` and ``date_diff`` over both, typed interval
arithmetic, ``from_unixtime``/``to_unixtime`` and the DATE <-> TIMESTAMP
casts; and the catalog's timestamp ingest (a ``datetime64`` column finer
than a day is a microsecond TIMESTAMP, not a DATE). Integers, dates,
timestamps and NULL masks must be equal, DOUBLE results to rtol=1e-9.
The JAX rows are computed once per module."""

import datetime

import numpy as np
import pytest

from torch_tpch_data import assert_same, table_in_both, values_in_both
from velox_tpu.exec import run_plan as jax_run_plan
from velox_tpu.plan import PlanBuilder as JaxPlanBuilder
from velox_tpu_torch.exec import run_plan as torch_run_plan
from velox_tpu_torch.plan import PlanBuilder as TorchPlanBuilder

N = 160
PARTS = ["year", "quarter", "month", "week", "week_of_year", "day",
         "day_of_month", "day_of_week", "dow", "day_of_year", "doy",
         "year_of_week", "yow", "last_day_of_month"]
TRUNC_UNITS = ["second", "minute", "hour", "day", "week", "month",
               "quarter", "year"]
DAY_UNITS = ["day", "week", "month", "quarter", "year"]
TIME_UNITS = ["hour", "minute", "second", "millisecond"]
EDGE_DATES = [
    "1970-01-01", "1969-12-31", "1900-02-28", "1900-03-01", "2000-02-29",
    "2024-02-29", "2023-02-28", "2020-12-31", "2021-01-01", "2021-01-03",
    "2021-01-04", "2015-12-31", "2016-01-03", "2008-12-29", "1999-12-31",
    "2000-01-31", "2000-03-31", "2001-05-31", "1600-03-01", "1583-01-01",
    "2026-12-31", "1976-12-31", "1977-01-02", "2004-12-31",
]
EDGE_TIMES = [
    "1969-12-31T23:59:59.999999", "1970-01-01T00:00:00.000001",
    "1900-01-01T00:00:00.000001", "2000-02-29T23:59:59.500000",
    "2020-12-31T12:34:56.789012", "1950-06-15T06:07:08.090807",
    "2024-01-31T23:00:00", "1969-01-01T00:00:00",
]

PROJECTIONS = {
    "parts_date": {p: f"{p}(d)" for p in PARTS},
    "parts_timestamp": {
        **{f"{p}_ts": f"{p}(ts)" for p in PARTS},
        **{u: f"{u}(ts)" for u in TIME_UNITS},
    },
    "trunc": {
        **{f"trunc_{u}_d": f"date_trunc('{u}', d)"
           for u in ["day", "week", "month", "quarter", "year"]},
        **{f"trunc_{u}_ts": f"date_trunc('{u}', ts)" for u in TRUNC_UNITS},
        "trunc_upper": "date_trunc('MONTH', d)",
    },
    "add": {
        **{f"add_{u}_d": f"date_add('{u}', n, d)" for u in DAY_UNITS},
        **{f"add_{u}_ts": f"date_add('{u}', n, ts)"
           for u in DAY_UNITS + TIME_UNITS},
        "add_month_lit": "date_add('month', 1, d)",
    },
    "diff": {
        **{f"diff_{u}_d": f"date_diff('{u}', d, d2)" for u in DAY_UNITS},
        **{f"diff_{u}_ts": f"date_diff('{u}', ts, ts2)"
           for u in DAY_UNITS + TIME_UNITS},
    },
    "intervals": {
        "d_plus_year": "d + INTERVAL '1' YEAR",
        "d_minus_month": "d - INTERVAL '13' MONTH",
        "year_plus_d": "INTERVAL '2' YEAR + d",
        "d_plus_day": "d + INTERVAL '3' DAY",
        "d_minus_day": "d - INTERVAL '40' DAY",
        "ts_plus_month": "ts + INTERVAL '1' MONTH",
        "ts_minus_year": "ts - INTERVAL '1' YEAR",
        "ts_plus_hour": "ts + INTERVAL '5' HOUR",
        "ts_minus_second": "ts - INTERVAL '90' SECOND",
        "ts_plus_minute": "ts + INTERVAL '61' MINUTE",
        "ym_plus_ym": "INTERVAL '1' YEAR + INTERVAL '2' MONTH",
        "ym_times_n": "INTERVAL '2' MONTH * n",
        "n_times_dt": "n * INTERVAL '3' HOUR",
        "dt_minus_dt": "INTERVAL '3' HOUR - INTERVAL '20' MINUTE",
        "d_plus_ym_n": "d + INTERVAL '1' MONTH * n",
        "lit_1996": "DATE '1996-01-01' + INTERVAL '1' YEAR",
    },
    "unixtime_casts": {
        "to_unix": "to_unixtime(ts)",
        "from_unix": "from_unixtime(u)",
        "from_unix_off": "from_unixtime(u, h)",
        "from_unix_off2": "from_unixtime(u, h, 30)",
        "ts_to_date": "CAST(ts AS DATE)",
        "date_to_ts": "CAST(d AS TIMESTAMP)",
        "hour_from_unix": "hour(from_unixtime(u))",
    },
}


def _columns():
    rng = np.random.default_rng(20240614)
    d = rng.integers(-30000, 25000, N).astype("datetime64[D]")
    d[:len(EDGE_DATES)] = np.asarray(EDGE_DATES, dtype="datetime64[D]")
    d2 = d + rng.integers(-800, 800, N).astype("timedelta64[D]")
    d2[:len(EDGE_DATES)] = d[:len(EDGE_DATES)][::-1]
    us = rng.integers(-3 * 10 ** 15, 2 * 10 ** 15, N)
    ts = us.astype("datetime64[us]")
    ts[:len(EDGE_TIMES)] = np.asarray(EDGE_TIMES, dtype="datetime64[us]")
    ts2 = ts + rng.integers(-10 ** 11, 10 ** 11, N).astype("timedelta64[us]")
    ts2[:len(EDGE_TIMES)] = ts[:len(EDGE_TIMES)][::-1]
    cols = {
        "d": d, "d2": d2, "ts": ts, "ts2": ts2,
        "n": rng.integers(-30, 30, N),
        "u": np.round(rng.uniform(-2e9, 2e9, N), 3),
        "h": rng.integers(-12, 13, N),
    }
    nulls = {c: rng.random(N) < 0.1 for c in ("d", "ts", "n", "u", "d2")}
    nulls["d"][:len(EDGE_DATES)] = False
    nulls["ts"][:len(EDGE_TIMES)] = False
    return cols, nulls


@pytest.fixture(scope="module")
def rows():
    batches = values_in_both(*_columns())
    cache = {}

    def plan(builder, which, group):
        return builder().values(batches[which]).project(
            [f"{e} AS {n}" for n, e in PROJECTIONS[group].items()])

    def get(group):
        if group not in cache:
            cache[group] = jax_run_plan(
                plan(JaxPlanBuilder, 0, group).build()).to_pydict()
        return cache[group], torch_run_plan(plan(TorchPlanBuilder, 1, group))

    return get


@pytest.mark.parametrize("group", list(PROJECTIONS))
def test_dates_match_jax(rows, group):
    exp, got = rows(group)
    assert_same(got, exp, group)


def test_iso_weeks_and_leap_days(rows):
    """The calendar edges themselves, beside the JAX package's answer."""
    exp, got = rows("parts_date")
    i = EDGE_DATES.index
    assert got["week"][i("2020-12-31")] == 53
    assert got["week"][i("2021-01-03")] == 53          # 2020's week 53
    assert got["year_of_week"][i("2021-01-03")] == 2020
    assert got["week"][i("2021-01-04")] == 1
    assert got["week"][i("2008-12-29")] == 1           # 2009's week 1
    assert got["year_of_week"][i("2008-12-29")] == 2009
    assert got["last_day_of_month"][i("1900-02-28")] == \
        datetime.date(1900, 2, 28)
    assert got["last_day_of_month"][i("2000-02-29")] == \
        datetime.date(2000, 2, 29)
    assert got["day_of_year"][i("2024-02-29")] == 60
    assert got == exp


def test_month_arithmetic_clamps_to_month_end(rows):
    exp, got = rows("intervals")
    i = EDGE_DATES.index
    # 2024-02-29 + 1 year clamps to the month's last day
    assert got["d_plus_year"][i("2024-02-29")] == datetime.date(2025, 2, 28)
    assert got["lit_1996"][0] == datetime.date(1997, 1, 1)
    assert exp["lit_1996"][0] == datetime.date(1997, 1, 1)
    assert got["ym_plus_ym"][0] == 14                   # months
    assert got["dt_minus_dt"][0] == 3 * 3_600_000 - 20 * 60_000   # ms


@pytest.mark.parametrize("unit", ["us", "ms", "s"])
def test_timestamp_columns_ingest_as_timestamps(unit):
    """A ``datetime64`` column finer than a day is read back with its
    time of day, as the JAX package's Arrow ingest keeps it; a day column
    is still a DATE."""
    ts = np.asarray(["2024-03-01T13:45:10.123456", "1999-12-31T23:59:59",
                     "1969-12-31T23:59:59.5", "1900-01-01T00:00:00.000001"],
                    dtype="datetime64[us]").astype(f"datetime64[{unit}]")
    cols = {"ts": ts, "d": ts.astype("datetime64[D]"), "x": np.arange(4)}
    with table_in_both("tsi", cols):
        exp = jax_run_plan(JaxPlanBuilder().table_scan("tsi").project(
            ["ts", "d", "hour(ts) AS h", "CAST(ts AS DATE) AS td"]).build()
        ).to_pydict()
        got = torch_run_plan(TorchPlanBuilder().table_scan("tsi").project(
            ["ts", "d", "hour(ts) AS h", "CAST(ts AS DATE) AS td"]))
    assert got == exp
    assert got["ts"] == [v.item() for v in ts.astype("datetime64[us]")]
    assert all(type(v) is datetime.datetime for v in got["ts"])
    assert all(type(v) is datetime.date for v in got["d"])
