"""The scalar-function families over the TPC-H tables at full width, and
their oracles computed on the host from the generated arrays.

Each family is one plan over real columns: ``dates`` (date parts, ISO
weeks, every unit of ``date_trunc``/``date_add``/``date_diff`` and
typed interval arithmetic over ``l_shipdate``, ``l_commitdate`` and
``l_receiptdate``), ``timestamps`` (the TIMESTAMP functions over
``from_unixtime`` of lineitem keys), ``math`` (over ``l_extendedprice``
and ``l_discount`` as DOUBLE), ``bits`` (bitwise functions, shifts and
the device hashes over ``l_orderkey`` and ``l_partkey``), ``nulls``
(``nullif(l_discount, 0.00)`` makes NULLs in about one row in eleven,
fed to ``coalesce``, ``greatest``, ``least``, ``IS DISTINCT FROM`` and
``IS NULL``, under a filter with ``negate`` and ``%``), and
``probability`` over ``part`` (its oracle is scipy, which the package
does not import: the caller brings it). ``AGGREGATE`` sums integer
results of new functions grouped by ``l_returnflag, l_linestatus``,
Q1's kArray keys, which under narrow lanes is one launch of the
grouped-sum kernel B2 per split. ``TIMESTAMP_TABLE`` is a seeded table
of ``datetime64[us]`` values, registered as a TIMESTAMP column.

Oracles compute each checked column in its lane form: DATE as int32
days, TIMESTAMP as int64 microseconds, decimals as unscaled integers,
with a NULL mask where the column has NULLs. Calendar answers come from
Python's ``datetime`` once per distinct day, then a gather; the rest is
numpy (uint64 for the hashes).
"""

from __future__ import annotations

import calendar
import datetime
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from velox_tpu_torch.tpcds.window_plans import Arrays

_EPOCH = datetime.date(1970, 1, 1)
US_DAY = 86_400_000_000

#: the timestamps the ``timestamps`` family derives from lineitem keys
TS_EXPR = ("from_unixtime(CAST(l_orderkey AS DOUBLE) * 37.5 - 1200000000.0"
           " + CAST(l_partkey AS DOUBLE) * 0.000001)")
TS2_EXPR = "from_unixtime(CAST(l_partkey AS DOUBLE) * 1500.25 - 900000000.0)"

DATES = {
    "year": "year(l_shipdate)", "quarter": "quarter(l_shipdate)",
    "month": "month(l_shipdate)", "week": "week(l_shipdate)",
    "day": "day(l_shipdate)", "dow": "day_of_week(l_shipdate)",
    "doy": "day_of_year(l_shipdate)", "yow": "year_of_week(l_receiptdate)",
    "ldom": "last_day_of_month(l_commitdate)",
    "tr_week": "date_trunc('week', l_shipdate)",
    "tr_month": "date_trunc('month', l_shipdate)",
    "tr_quarter": "date_trunc('quarter', l_receiptdate)",
    "tr_year": "date_trunc('year', l_commitdate)",
    "add_day": "date_add('day', 45, l_shipdate)",
    "add_week": "date_add('week', -3, l_receiptdate)",
    "add_month": "date_add('month', 7, l_commitdate)",
    "add_quarter": "date_add('quarter', -2, l_receiptdate)",
    "add_year": "date_add('year', 1, l_shipdate)",
    "diff_day": "date_diff('day', l_shipdate, l_receiptdate)",
    "diff_week": "date_diff('week', l_receiptdate, l_commitdate)",
    "diff_month": "date_diff('month', l_commitdate, l_shipdate)",
    "diff_quarter": "date_diff('quarter', DATE '1995-02-28', l_shipdate)",
    "diff_year": "date_diff('year', l_receiptdate, DATE '1996-02-29')",
    "iv_month": "l_shipdate + INTERVAL '1' MONTH",
    "iv_year": "l_receiptdate - INTERVAL '2' YEAR",
    "iv_day": "l_shipdate + INTERVAL '10' DAY",
    "iv_months": "l_commitdate + INTERVAL '13' MONTH",
}

TIMESTAMPS = {
    "ts": "ts", "hour": "hour(ts)", "minute": "minute(ts)",
    "second": "second(ts)", "ms": "millisecond(ts)", "year": "year(ts)",
    "month": "month(ts)", "dow": "day_of_week(ts)", "week": "week(ts)",
    "tr_hour": "date_trunc('hour', ts)", "tr_day": "date_trunc('day', ts)",
    "tr_month": "date_trunc('month', ts)",
    "add_hour": "date_add('hour', 5, ts)",
    "add_month": "date_add('month', -1, ts)",
    "add_ms": "date_add('millisecond', 1500, ts)",
    "diff_second": "date_diff('second', ts, ts2)",
    "diff_day": "date_diff('day', ts, ts2)",
    "diff_month": "date_diff('month', ts2, ts)",
    "iv_month": "ts + INTERVAL '1' MONTH",
    "iv_hour": "ts - INTERVAL '3' HOUR",
    "unix": "to_unixtime(ts)", "as_date": "CAST(ts AS DATE)",
}

PRICE = "CAST(l_extendedprice AS DOUBLE)"
DISC = "CAST(l_discount AS DOUBLE)"
MATH = {
    "round2": "round(price / 7.0, 2)", "round0": "round(price / 3.0)",
    "floor": "floor(price / 7.0)", "ceil": "ceil(price / 7.0)",
    "truncate": "truncate(price / 7.0, 1)", "sign": "sign(disc - 0.05)",
    "sqrt": "sqrt(price)", "cbrt": "cbrt(price)", "ln": "ln(price)",
    "log10": "log10(price)", "exp": "exp(disc * 10.0)",
    "power": "power(disc, 0.5)", "sin": "sin(price)", "cos": "cos(price)",
    "atan2": "atan2(disc, 0.05)", "tanh": "tanh(disc * 10.0 - 0.5)",
    "degrees": "degrees(disc)",
    "width_bucket": "width_bucket(price, 900.0, 105000.0, 50)",
    "clamp": "clamp(price, 1000.0, 50000.0)",
    "pmod": "pmod(price, 97.5)", "pmod_key": "pmod(l_orderkey, 7)",
    "gcd": "great_circle_distance(disc * 900.0 - 45.0, price / 1000.0, "
           "10.0, 20.0)",
    "nan": "is_nan(ln(disc - 0.05))", "finite": "is_finite(ln(disc))",
}

BITS = {
    "band": "bitwise_and(l_orderkey, 1023)",
    "bor": "bitwise_or(l_orderkey, l_partkey)",
    "bxor": "bitwise_xor(l_orderkey, l_partkey)",
    "bnot": "bitwise_not(l_partkey)",
    "shl": "bitwise_left_shift(l_orderkey, l_partkey % 70)",
    "shr": "bitwise_right_shift(bitwise_not(l_orderkey), l_partkey % 70)",
    "sar": "bitwise_arithmetic_shift_right(-l_orderkey, l_partkey % 70)",
    "lsr_bits": "bitwise_logical_shift_right(bitwise_not(l_partkey), 3, 20)",
    "shl_bits": "bitwise_shift_left(l_orderkey, 5, 32)",
    "bit_count": "bit_count(bitwise_not(l_orderkey), 64)",
    "xx_order": "xxhash64_internal(l_orderkey)",
    "xx_part": "xxhash64_internal(l_partkey)",
    "xx_price": "xxhash64_internal(CAST(l_extendedprice AS DOUBLE))",
    "combine": "combine_hash_internal(xxhash64_internal(l_orderkey), "
               "xxhash64_internal(l_partkey))",
}

NULLS_FILTER = "-l_quantity < -25.00 AND l_orderkey % 3 = 1"
NULLS = {
    "nd": "nullif(l_discount, 0.00)",
    "co": "coalesce(nullif(l_discount, 0.00), l_tax)",
    "gr": "greatest(l_discount, l_tax)", "le": "least(l_discount, l_tax)",
    "gr_null": "greatest(nullif(l_discount, 0.00), l_tax)",
    "df": "distinct_from(nullif(l_discount, 0.00), l_tax)",
    "isn": "nullif(l_discount, 0.00) IS NULL",
    "isnn": "nullif(l_tax, 0.00) IS NOT NULL",
    "neg": "-l_quantity", "mod": "l_orderkey % 7",
    "mod_dec": "l_quantity % 3.01",
}

#: uniform draws checked by range and type (no oracle can know them)
RANDOM = {"rand": "rand()", "rand7": "rand(7)"}

PROBABILITY = {
    "normal": "normal_cdf(25.0, 10.0, s)",
    "cauchy": "cauchy_cdf(0.0, 2.0, xs)",
    "chi2": "chi_squared_cdf(p_size, x)", "gamma": "gamma_cdf(p_size, 0.5, x)",
    "laplace": "laplace_cdf(0.0, 3.0, xs)",
    "poisson": "poisson_cdf(p_size, p_partkey % 60)",
    "weibull": "weibull_cdf(1.5, 8.0, x)", "beta": "beta_cdf(p_size, 3.5, pr)",
    "f": "f_cdf(p_size, 7.0, x)",
    "binomial": "binomial_cdf(p_size + 10, 0.3, p_partkey % 30)",
    "t": "t_cdf(p_size, xs)",
    "wilson_lo": "wilson_interval_lower(p_size, p_size + 20, 1.96)",
    "wilson_hi": "wilson_interval_upper(p_size, p_size + 20, 1.96)",
    "inv_normal": "inverse_normal_cdf(0.0, 1.0, pr)",
    "inv_cauchy": "inverse_cauchy_cdf(0.0, 2.0, pr)",
    "inv_laplace": "inverse_laplace_cdf(0.0, 3.0, pr)",
    "inv_weibull": "inverse_weibull_cdf(1.5, 8.0, pr)",
    "inv_beta": "inverse_beta_cdf(p_size, 3.5, pr)",
    "inv_chi2": "inverse_chi_squared_cdf(p_size, pr)",
    "inv_gamma": "inverse_gamma_cdf(p_size, 0.5, pr)",
    "inv_f": "inverse_f_cdf(p_size, 7.0, pr)",
    "inv_t": "inverse_t_cdf(p_size, pr)",
    "inv_binomial": "inverse_binomial_cdf(p_size + 10, 0.3, pr)",
    "inv_poisson": "inverse_poisson_cdf(p_size, pr)",
}

AGGREGATE_SUMS = {
    "s_band": "bitwise_and(l_orderkey, 1023)",
    "s_diff": "date_diff('day', l_shipdate, l_receiptdate)",
    "s_dow": "day_of_week(l_shipdate)",
    "s_pmod": "l_partkey % 7",
}


def _project(exprs: Dict[str, str]) -> List[str]:
    return [f"{e} AS {n}" for n, e in exprs.items()]


def plan_dates(pb):
    return pb().table_scan("lineitem", columns=[
        "l_shipdate", "l_commitdate", "l_receiptdate"]).project(
        _project(DATES))


def plan_timestamps(pb):
    return (pb().table_scan("lineitem", columns=["l_orderkey", "l_partkey"])
            .project([f"{TS_EXPR} AS ts", f"{TS2_EXPR} AS ts2"])
            .project(_project(TIMESTAMPS)))


def plan_math(pb):
    return (pb().table_scan("lineitem", columns=[
        "l_orderkey", "l_extendedprice", "l_discount"])
        .project(["l_orderkey", f"{PRICE} AS price", f"{DISC} AS disc"])
        .project(_project(MATH)))


def plan_bits(pb):
    return pb().table_scan("lineitem", columns=[
        "l_orderkey", "l_partkey", "l_extendedprice"]).project(
        _project(BITS))


def plan_nulls(pb):
    return (pb().table_scan("lineitem", columns=[
        "l_orderkey", "l_quantity", "l_discount", "l_tax"])
        .filter(NULLS_FILTER).project(_project({**NULLS, **RANDOM})))


def plan_probability(pb):
    return (pb().table_scan("part", columns=["p_partkey", "p_size"])
            .project(["p_partkey", "p_size",
                      "CAST(p_size AS DOUBLE) AS s",
                      "(CAST(p_partkey % 9973 AS DOUBLE) + 0.5) / 9973.0 "
                      "AS pr",
                      "CAST(p_partkey % 2000 AS DOUBLE) / 100.0 AS x",
                      "CAST(p_partkey % 2000 AS DOUBLE) / 100.0 - 10.0 "
                      "AS xs"])
            .project(_project(PROBABILITY)))


def plan_aggregate(pb):
    return (pb().table_scan("lineitem", columns=[
        "l_returnflag", "l_linestatus", "l_orderkey", "l_partkey",
        "l_shipdate", "l_receiptdate"])
        .project(["l_returnflag", "l_linestatus"]
                 + _project(AGGREGATE_SUMS))
        .aggregate(["l_returnflag", "l_linestatus"],
                   [f"sum({n}) AS {n}" for n in AGGREGATE_SUMS]
                   + ["count(*) AS n"])
        .order_by(["l_returnflag", "l_linestatus"]))


def plan_timestamp_table(pb):
    return pb().table_scan(TIMESTAMP_TABLE).project(
        _project(TIMESTAMP_TABLE_EXPRS))


TIMESTAMP_TABLE = "scalar_timestamps"
TIMESTAMP_TABLE_EXPRS = {
    "t": "t", "hour": "hour(t)", "minute": "minute(t)", "second": "second(t)",
    "ms": "millisecond(t)", "year": "year(t)", "dow": "day_of_week(t)",
    "tr_day": "date_trunc('day', t)", "as_date": "CAST(t AS DATE)",
}


def timestamp_table_columns(rows: int, seed: int) -> Dict[str, np.ndarray]:
    """``rows`` seeded microsecond timestamps from 1906 to 2033, a third
    of them before 1970."""
    rng = np.random.default_rng(seed)
    us = rng.integers(-2 * 10 ** 15, 2 * 10 ** 15, rows)
    return {"t": us.astype("datetime64[us]")}


#: family -> (plan, checked columns); probability's oracle is the caller's
FAMILIES: Dict[str, Tuple[Callable, List[str]]] = {
    "dates": (plan_dates, list(DATES)),
    "timestamps": (plan_timestamps, list(TIMESTAMPS)),
    "math": (plan_math, list(MATH)),
    "bits": (plan_bits, list(BITS)),
    "nulls": (plan_nulls, list(NULLS) + list(RANDOM)),
    "probability": (plan_probability, list(PROBABILITY)),
}


# ------------------------------------------------------------- oracles

def _days(a: np.ndarray) -> np.ndarray:
    return a.astype("datetime64[D]").astype(np.int64)


class _Calendar:
    """Python ``datetime`` answers for every day in [lo, hi]. A column's
    oracle is computed once per day of that range (``per_day``), then
    gathered by day number: lineitem's dates span a few thousand days."""

    def __init__(self, lo: int, hi: int):
        self.lo = lo
        self.days = np.arange(lo, hi + 1)
        dates = [_EPOCH + datetime.timedelta(days=int(d)) for d in self.days]
        iso = [d.isocalendar() for d in dates]
        self.y = np.asarray([d.year for d in dates], np.int64)
        self.m = np.asarray([d.month for d in dates], np.int64)
        self.d = np.asarray([d.day for d in dates], np.int64)
        self.week = np.asarray([i[1] for i in iso], np.int64)
        self.iso_year = np.asarray([i[0] for i in iso], np.int64)
        self.dow = np.asarray([i[2] for i in iso], np.int64)
        self.doy = np.asarray([d.timetuple().tm_yday for d in dates],
                              np.int64)
        self.month_days = np.asarray(
            [calendar.monthrange(d.year, d.month)[1] for d in dates],
            np.int64)

    def at(self, table: np.ndarray, days: np.ndarray) -> np.ndarray:
        """``table`` (one value per day of the range) at ``days``."""
        return table[days - self.lo]

    def add_months(self, n: int) -> np.ndarray:
        """Each day of the range plus ``n`` months, the day clamped to the
        target month's end."""
        months = self.y * 12 + self.m - 1 + n
        y, m = months // 12, months % 12 + 1
        first = _days_of(y, m, np.ones_like(y))
        length = _days_of(y + (m == 12), m % 12 + 1, np.ones_like(y)) - first
        return first + np.minimum(self.d, length) - 1

    def months_between(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Whole months from day ``a`` to day ``b``; a partial month does
        not count."""
        month_index = self.y * 12 + self.m
        return (self.at(month_index, b) - self.at(month_index, a)
                - (self.at(self.d, b) < self.at(self.d, a)))


def _days_of(y, m, d) -> np.ndarray:
    """Day numbers of civil dates (numpy's proleptic Gregorian)."""
    months = (y - 1970) * 12 + (m - 1)
    first = months.astype("datetime64[M]").astype("datetime64[D]")
    return first.astype(np.int64) + d - 1


def _calendar_for(*days: np.ndarray) -> _Calendar:
    return _Calendar(int(min(d.min() for d in days)) - 800,
                     int(max(d.max() for d in days)) + 800)


def _i32(v):
    return (np.asarray(v, dtype=np.int32), None)


def _i64(v):
    return (np.asarray(v, dtype=np.int64), None)


def oracle_dates(li) -> Arrays:
    ship, commit, receipt = (_days(li[c]) for c in (
        "l_shipdate", "l_commitdate", "l_receiptdate"))
    cal = _calendar_for(ship, commit, receipt)
    r = cal.days
    lit_a = int(np.datetime64("1995-02-28").astype(np.int64))
    lit_b = int(np.datetime64("1996-02-29").astype(np.int64))
    full = np.ones_like(r)
    per_day = {   # name -> (its table over the range, the column it reads)
        "year": (cal.y, ship), "quarter": ((cal.m - 1) // 3 + 1, ship),
        "month": (cal.m, ship), "week": (cal.week, ship),
        "day": (cal.d, ship), "dow": (cal.dow, ship),
        "doy": (cal.doy, ship), "yow": (cal.iso_year, receipt),
        "ldom": (r - cal.d + cal.month_days, commit),
        "tr_week": (r - cal.dow + 1, ship),
        "tr_month": (r - cal.d + 1, ship),
        "tr_quarter": (_days_of(cal.y, (cal.m - 1) // 3 * 3 + 1, full),
                       receipt),
        "tr_year": (_days_of(cal.y, full, full), commit),
        "add_day": (r + 45, ship), "add_week": (r - 21, receipt),
        "add_month": (cal.add_months(7), commit),
        "add_quarter": (cal.add_months(-6), receipt),
        "add_year": (cal.add_months(12), ship),
        "diff_quarter": (np.floor_divide(
            cal.months_between(full * lit_a, r), 3), ship),
        "diff_year": (np.floor_divide(
            cal.months_between(r, full * lit_b), 12), receipt),
        "iv_month": (cal.add_months(1), ship),
        "iv_year": (cal.add_months(-24), receipt),
        "iv_day": (r + 10, ship), "iv_months": (cal.add_months(13), commit),
    }
    # one offset array per date column, then one gather per output
    offsets = {id(c): c - cal.lo for c in (ship, commit, receipt)}
    out = {name: np.take(table, offsets[id(days)])
           for name, (table, days) in per_day.items()}
    out["diff_day"] = receipt - ship
    out["diff_week"] = np.floor_divide(commit - receipt, 7)
    out["diff_month"] = cal.months_between(commit, ship)
    dates = {"ldom", "tr_week", "tr_month", "tr_quarter", "tr_year",
             "add_day", "add_week", "add_month", "add_quarter", "add_year",
             "iv_month", "iv_year", "iv_day", "iv_months"}
    return {name: (_i32 if name in dates else _i64)(out[name])
            for name in DATES}


def _timestamps_us(li) -> Tuple[np.ndarray, np.ndarray]:
    """``TS_EXPR`` and ``TS2_EXPR`` in the engine's order of IEEE
    operations, then truncated to whole microseconds."""
    ok = li["l_orderkey"].astype(np.float64)
    pk = li["l_partkey"].astype(np.float64)
    ts = ((ok * 37.5 - 1200000000.0 + pk * 0.000001) * 1e6).astype(np.int64)
    ts2 = ((pk * 1500.25 - 900000000.0) * 1e6).astype(np.int64)
    return ts, ts2


def _time_parts(ts: np.ndarray, day: np.ndarray) -> Dict[str, np.ndarray]:
    """Hour, minute, second and millisecond of int64 microseconds."""
    tod = ts - day * US_DAY
    return {"hour": tod // 3_600_000_000,
            "minute": tod // 60_000_000 % 60,
            "second": tod // 1_000_000 % 60, "ms": tod // 1_000 % 1_000}


def oracle_timestamps(li) -> Arrays:
    ts, ts2 = _timestamps_us(li)
    day, day2 = np.floor_divide(ts, US_DAY), np.floor_divide(ts2, US_DAY)
    tod = ts - day * US_DAY
    cal = _calendar_for(day, day2)
    return {k: _i64(v) for k, v in {
        "ts": ts, **_time_parts(ts, day),
        "year": cal.at(cal.y, day), "month": cal.at(cal.m, day),
        "dow": cal.at(cal.dow, day), "week": cal.at(cal.week, day),
        "tr_hour": ts - tod % 3_600_000_000, "tr_day": day * US_DAY,
        "tr_month": cal.at(cal.days - cal.d + 1, day) * US_DAY,
        "add_hour": ts + 5 * 3_600_000_000,
        "add_month": cal.at(cal.add_months(-1), day) * US_DAY + tod,
        "add_ms": ts + 1_500_000,
        "diff_second": np.floor_divide(ts2 - ts, 1_000_000),
        "diff_day": day2 - day,
        "diff_month": cal.months_between(day2, day),
        "iv_month": cal.at(cal.add_months(1), day) * US_DAY + tod,
        "iv_hour": ts - 3 * 3_600_000_000}.items()} | {
        "unix": (ts.astype(np.float64) / 1e6, None), "as_date": _i32(day)}


def oracle_timestamp_table(cols) -> Arrays:
    ts = cols["t"].astype(np.int64)
    day = np.floor_divide(ts, US_DAY)
    cal = _calendar_for(day)
    return {"t": _i64(ts),
            **{k: _i64(v) for k, v in _time_parts(ts, day).items()},
            "year": _i64(cal.at(cal.y, day)),
            "dow": _i64(cal.at(cal.dow, day)),
            "tr_day": _i64(day * US_DAY), "as_date": _i32(day)}


def oracle_math(li) -> Arrays:
    price = li["l_extendedprice"] / 100          # the decimal cast's rule
    disc = li["l_discount"] / 100
    with np.errstate(divide="ignore", invalid="ignore"):
        a7, a3 = price / 7.0, price / 3.0
        r = np.fmod(price, 97.5)
        bucket = np.floor((price - 900.0) / (105000.0 - 900.0) * 50) + 1
        bucket = np.where(price < 900.0, 0, np.where(
            price >= 105000.0, 51, np.clip(bucket, 1, 50)))
        lat1, lon1 = np.radians(disc * 900.0 - 45.0), price / 1000.0
        lat2 = np.radians(10.0)
        h = (np.sin((lat2 - lat1) / 2) ** 2 + np.cos(lat1) * np.cos(lat2)
             * np.sin(np.radians(20.0 - lon1) / 2) ** 2)
        out = {
            "round2": np.sign(a7) * np.floor(np.abs(a7) * 100.0 + 0.5) / 100.0,
            "round0": np.sign(a3) * np.floor(np.abs(a3) + 0.5),
            "floor": np.floor(a7), "ceil": np.ceil(a7),
            "truncate": np.trunc(a7 * 10.0) / 10.0,
            "sign": np.sign(disc - 0.05), "sqrt": np.sqrt(price),
            "cbrt": np.cbrt(price), "ln": np.log(price),
            "log10": np.log10(price), "exp": np.exp(disc * 10.0),
            "power": np.power(disc, 0.5), "sin": np.sin(price),
            "cos": np.cos(price), "atan2": np.arctan2(disc, 0.05),
            "tanh": np.tanh(disc * 10.0 - 0.5), "degrees": np.degrees(disc),
            "width_bucket": bucket.astype(np.int64),
            "clamp": np.clip(price, 1000.0, 50000.0),
            "pmod": np.where((r != 0) & (r < 0), r + 97.5, r),
            "pmod_key": np.mod(li["l_orderkey"], 7),
            "gcd": 2 * 6371.01 * np.arcsin(np.sqrt(np.clip(h, 0, 1))),
            "nan": np.isnan(np.log(disc - 0.05)),
            "finite": np.isfinite(np.log(disc)),
        }
    return {k: (v, None) for k, v in out.items()}


_M64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def _xxh64(x: np.ndarray) -> np.ndarray:
    """XXH64 of each value's 8 little-endian bytes (seed 0), in uint64."""
    p1, p2, p3 = (np.uint64(0x9E3779B185EBCA87), np.uint64(0xC2B2AE3D27D4EB4F),
                  np.uint64(0x165667B19E3779F9))
    p4, p5 = np.uint64(0x85EBCA77C2B2AE63), np.uint64(0x27D4EB2F165667C5)

    def rotl(v, r):
        return (v << np.uint64(r)) | (v >> np.uint64(64 - r))

    with np.errstate(over="ignore"):
        k1 = rotl(x.view(np.uint64) * p2, 31) * p1
        h = (p5 + np.uint64(8)) ^ k1
        h = rotl(h, 27) * p1 + p4
        h = (h ^ (h >> np.uint64(33))) * p2
        h = (h ^ (h >> np.uint64(29))) * p3
        return (h ^ (h >> np.uint64(32))).view(np.int64)


#: set bits of each byte value
_BYTE_BITS = np.asarray([bin(b).count("1") for b in range(256)], np.int64)


def _shift_left(x: np.ndarray, s: np.ndarray) -> np.ndarray:
    u = x.view(np.uint64) << np.minimum(s, 63).astype(np.uint64)
    return np.where(s >= 64, 0, u.view(np.int64))


def oracle_bits(li) -> Arrays:
    ok = li["l_orderkey"].astype(np.int64)
    pk = li["l_partkey"].astype(np.int64)
    s = pk % 70
    price = li["l_extendedprice"] / 100
    not_ok = ~ok
    s63 = np.minimum(s, 63)              # numpy shifts wrap at 64: clamp
    lsr = np.where(s >= 64, 0, (not_ok.view(np.uint64)
                                >> s63.astype(np.uint64)).view(np.int64))
    window = (~pk) & ((1 << 20) - 1)
    popcount = _BYTE_BITS[not_ok.view(np.uint8)].reshape(-1, 8).sum(1)
    with np.errstate(over="ignore"):
        combine = _xxh64(ok) * np.int64(31) + _xxh64(pk)
    return {k: _i64(v) for k, v in {
        "band": ok & 1023, "bor": ok | pk, "bxor": ok ^ pk, "bnot": ~pk,
        "shl": _shift_left(ok, s), "shr": lsr, "sar": (-ok) >> s63,
        "lsr_bits": window >> 3,
        "shl_bits": _shift_left(ok, np.full_like(ok, 5)) & 0xFFFFFFFF,
        "bit_count": popcount, "xx_order": _xxh64(ok),
        "xx_part": _xxh64(pk), "xx_price": _xxh64(price),
        "combine": combine}.items()}


def oracle_nulls(li) -> Arrays:
    q, ok = li["l_quantity"], li["l_orderkey"]
    keep = (-q < -2500) & (ok % 3 == 1)
    d, t, q, ok = li["l_discount"][keep], li["l_tax"][keep], q[keep], ok[keep]
    zero = d == 0
    return {
        "nd": (d, ~zero), "co": (np.where(zero, t, d), None),
        "gr": (np.maximum(d, t), None), "le": (np.minimum(d, t), None),
        "gr_null": (np.maximum(d, t), ~zero),
        "df": (np.where(zero, True, d != t), None),
        "isn": (zero, None), "isnn": (t != 0, None),
        "neg": (-q, None), "mod": _i64(np.fmod(ok, 7)),
        "mod_dec": (np.fmod(q, 301), None),
    }


def oracle_aggregate(li, dicts) -> Dict[str, list]:
    """The aggregation's rows, in ``order_by`` order (the dictionaries
    are sorted, so code order is value order)."""
    ok = li["l_orderkey"].astype(np.int64)
    pk = li["l_partkey"].astype(np.int64)
    ship, receipt = _days(li["l_shipdate"]), _days(li["l_receiptdate"])
    cal = _calendar_for(ship)
    rf = li["l_returnflag"].astype(np.int64)
    ls = li["l_linestatus"].astype(np.int64)
    radix = len(dicts["l_linestatus"])
    gid = rf * radix + ls
    sums = {"s_band": ok & 1023, "s_diff": receipt - ship,
            "s_dow": cal.at(cal.dow, ship), "s_pmod": np.fmod(pk, 7)}
    groups = np.unique(gid)
    out = {"l_returnflag": [dicts["l_returnflag"][g // radix]
                            for g in groups],
           "l_linestatus": [dicts["l_linestatus"][g % radix]
                            for g in groups]}
    for name, v in sums.items():
        out[name] = [int(np.bincount(gid, weights=v.astype(np.float64),
                                     minlength=groups.max() + 1)[g])
                     for g in groups]
    out["n"] = [int((gid == g).sum()) for g in groups]
    return out


ORACLES = {"dates": oracle_dates, "timestamps": oracle_timestamps,
           "math": oracle_math, "bits": oracle_bits, "nulls": oracle_nulls}


def check_random(got: Arrays) -> Optional[str]:
    """The uniform draws: DOUBLE in [0, 1), BIGINT in [0, 7), no NULLs,
    and not all equal."""
    r, rm = got["rand"]
    r7, r7m = got["rand7"]
    if rm is not None or r7m is not None:
        return "rand: NULLs"
    if r.dtype != np.float64 or not ((r >= 0) & (r < 1)).all():
        return f"rand(): {r.dtype} in [{r.min()}, {r.max()}]"
    if r7.dtype != np.int64 or set(np.unique(r7)) != set(range(7)):
        return f"rand(7): {r7.dtype}, values {np.unique(r7)}"
    if len(r) > 1 and r.min() == r.max():
        return "rand(): every draw equal"
    return None
