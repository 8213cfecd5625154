"""Date and timestamp functions (Presto semantics), over torch.

The JAX package's date parts, ISO weeks, ``date_trunc``/``date_add``/
``date_diff`` units and timestamp functions
(velox/functions/prestosql/DateTimeFunctions.h). DATE lanes are int32
days since 1970-01-01 and TIMESTAMP lanes int64 microseconds, so an
impl that takes either tells them apart by the lane's dtype, as the
reference does. Civil dates are Howard Hinnant's days <-> civil
algorithms in integer lanes; month arithmetic clamps to the month's last
day. The compiler routes a TIMESTAMP argument of a day-granularity part
through ``__ts_days``, after ``__tz_adjust`` under a session time zone
that is not UTC (``config.session_timezone``, ``utils/tz.py``).
"""

from __future__ import annotations

import torch

from velox_tpu_torch import true_divide
from velox_tpu_torch.types import BIGINT, DATE, DOUBLE, TIMESTAMP
from velox_tpu_torch.functions.registry import ScalarFunction, register_function
from velox_tpu_torch.utils.tz import offsets_at

US_DAY = 86_400_000_000
US_HOUR = 3_600_000_000
US_MIN = 60_000_000
US_SEC = 1_000_000

#: microseconds of each sub-day unit of date_add/date_diff
_US_OF = {"hour": US_HOUR, "minute": US_MIN, "second": US_SEC,
          "millisecond": 1_000}
#: months of each month-based unit
_MONTHS_OF = {"month": 1, "quarter": 3, "year": 12}


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _is_ts(a) -> bool:
    return a.dtype == torch.int64


def _ts_days(ts):
    return _fdiv(ts, US_DAY).to(torch.int32)


def _civil_from_days(days):
    """(year, month, day) of int32 day numbers."""
    z = days.to(torch.int32) + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = yoe + era * 400 + (m <= 2).to(torch.int32)
    return y, m, d


def _days_from_civil(y, m, d):
    y = y - (m <= 2).to(y.dtype)
    era = _fdiv(y, 400)
    yoe = y - era * 400
    doy = _fdiv(153 * torch.where(m > 2, m - 3, m + 9) + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def _iso_dow(days):
    """ISO day of week, Monday 1 to Sunday 7 (1970-01-01 was a Thursday)."""
    return torch.remainder(days.to(torch.int32) + 3, 7) + 1


def _doy(days):
    days = days.to(torch.int32)
    y, _, _ = _civil_from_days(days)
    ones = torch.ones_like(y)
    return days - _days_from_civil(y, ones, ones) + 1


def _iso_weeks_in_year(y):
    def p(y):
        return torch.remainder(y + _fdiv(y, 4) - _fdiv(y, 100)
                               + _fdiv(y, 400), 7)
    return 52 + ((p(y) == 4) | (p(y - 1) == 3)).to(y.dtype)


def _raw_week(days):
    """(year, ISO week before the year remaps) of int32 days."""
    y, _, _ = _civil_from_days(days)
    return y, _fdiv(_doy(days) - _iso_dow(days) + 10, 7)


def _iso_week(days):
    y, w0 = _raw_week(days.to(torch.int32))
    # both remaps read the raw week: week 0 is the previous ISO year's
    # last week, and is not then clamped against this year's count
    return torch.where(w0 == 0, _iso_weeks_in_year(y - 1),
                       torch.where(w0 > _iso_weeks_in_year(y),
                                   torch.ones_like(w0), w0))


def _year_of_week(days):
    """The year that owns the date's ISO week."""
    y, w0 = _raw_week(days.to(torch.int32))
    return torch.where(w0 == 0, y - 1,
                       torch.where(w0 > _iso_weeks_in_year(y), y + 1, y))


def _days_in_month(y, m):
    ny = torch.where(m == 12, y + 1, y)
    nm = torch.where(m == 12, torch.ones_like(m), m + 1)
    ones = torch.ones_like(m)
    return _days_from_civil(ny, nm, ones) - _days_from_civil(y, m, ones)


def _last_day_of_month(days):
    y, m, _ = _civil_from_days(days)
    first = _days_from_civil(y, m, torch.ones_like(m))
    return first + _days_in_month(y, m) - 1


def _part(fn):
    return lambda a: fn(a).to(torch.int64)


for _name, _fn in [
    ("year", lambda a: _civil_from_days(a)[0]),
    ("month", lambda a: _civil_from_days(a)[1]),
    ("day", lambda a: _civil_from_days(a)[2]),
    ("day_of_month", lambda a: _civil_from_days(a)[2]),
    ("quarter", lambda a: _fdiv(_civil_from_days(a)[1] - 1, 3) + 1),
    ("day_of_week", _iso_dow), ("dow", _iso_dow),
    ("day_of_year", _doy), ("doy", _doy),
    ("week", _iso_week), ("week_of_year", _iso_week),
    ("year_of_week", _year_of_week), ("yow", _year_of_week),
]:
    register_function(ScalarFunction(_name, lambda a: BIGINT, _part(_fn)))
register_function(ScalarFunction(
    "last_day_of_month", lambda a: DATE,
    lambda a: _last_day_of_month(a).to(torch.int32)))


# ------------------------------------------------------------- timestamps

def _ts_part(div, mod):
    return lambda ts: _fdiv(torch.remainder(ts, mod), div).to(torch.int64)


def _from_unixtime(a, *offset):
    """Seconds since the epoch to microseconds; ``offset`` is (hours[,
    minutes]) of a fixed zone offset."""
    ts = (a.to(torch.float64) * 1e6).to(torch.int64)
    if offset:
        h = offset[0].to(torch.int64)
        m = offset[1].to(torch.int64) if len(offset) > 1 else 0
        ts = ts + (h * 3600 + torch.sign(h) * m * 60) * US_SEC
    return ts


register_function(ScalarFunction(
    "hour", lambda a: BIGINT, _ts_part(US_HOUR, US_DAY)))
register_function(ScalarFunction(
    "minute", lambda a: BIGINT, _ts_part(US_MIN, US_HOUR)))
register_function(ScalarFunction(
    "second", lambda a: BIGINT, _ts_part(US_SEC, US_MIN)))
register_function(ScalarFunction(
    "millisecond", lambda a: BIGINT, _ts_part(1_000, US_SEC)))
register_function(ScalarFunction(
    "to_unixtime", lambda a: DOUBLE,
    lambda a: true_divide(a.to(torch.float64), 1e6)))
register_function(ScalarFunction(
    "from_unixtime", lambda a: TIMESTAMP, _from_unixtime,
    promote_args=False))
# CAST(ts AS DATE) and the day parts of a TIMESTAMP
register_function(ScalarFunction("__ts_days", lambda a: DATE, _ts_days))


# ------------------------------------------------------------ time zones
# A zone is a ZoneTable literal (utils/tz.py); the compiler wraps the
# TIMESTAMP argument of a part in __tz_adjust under a session zone that
# is not UTC, and binds at_timezone/with_timezone to these names.

def _tz_adjust(ts, zone):
    return ts + offsets_at(ts, zone)


def _tz_unadjust(ts, zone):
    """Wall clock -> instant: the offset at the wall-clock value stands
    for the offset at the instant (one side of the hour around a DST
    flip, as the reference picks)."""
    return ts - offsets_at(ts, zone)


def _tz_offset_part(div):
    def impl(ts, zone):
        off_s = torch.div(offsets_at(ts, zone), US_SEC, rounding_mode="floor")
        mag = off_s.abs()
        # toward zero: -05:30 is hour -5, minute -30 (Presto)
        part = mag // 3600 if div == 3600 else (mag % 3600) // 60
        return (torch.where(off_s < 0, -part, part)).to(torch.int64)
    return impl


register_function(ScalarFunction(
    "__tz_adjust", lambda a: TIMESTAMP, _tz_adjust, promote_args=False))
register_function(ScalarFunction(
    "__tz_unadjust", lambda a: TIMESTAMP, _tz_unadjust, promote_args=False))
register_function(ScalarFunction(
    "__timezone_hour", lambda a: BIGINT, _tz_offset_part(3600),
    promote_args=False))
register_function(ScalarFunction(
    "__timezone_minute", lambda a: BIGINT, _tz_offset_part(60),
    promote_args=False))


# ------------------------------------------------------- unit functions
# date_trunc(unit, x), date_add(unit, n, x) and date_diff(unit, a, b) are
# specialized by unit when the compiler resolves them.

def _trunc_days(days, unit: str):
    if unit == "week":
        return days.to(torch.int32) - (_iso_dow(days) - 1)
    y, m, _ = _civil_from_days(days)
    one = torch.ones_like(m)
    if unit == "month":
        return _days_from_civil(y, m, one)
    if unit == "quarter":
        return _days_from_civil(y, _fdiv(m - 1, 3) * 3 + 1, one)
    return _days_from_civil(y, one, one)


def _date_trunc(unit: str):
    quantum = {"second": US_SEC, "minute": US_MIN, "hour": US_HOUR}.get(unit)

    def impl(a):
        if quantum is not None:
            return a - torch.remainder(a, quantum)
        if unit == "day":
            return a - torch.remainder(a, US_DAY) if _is_ts(a) else a
        if _is_ts(a):
            return _trunc_days(_ts_days(a), unit).to(torch.int64) * US_DAY
        return _trunc_days(a, unit).to(a.dtype)
    return impl


def _add_months_days(days, n):
    y, m, dd = _civil_from_days(days)
    m0 = m - 1 + n.to(torch.int32)
    y2 = y + _fdiv(m0, 12)
    m2 = torch.remainder(m0, 12) + 1
    return _days_from_civil(y2, m2, torch.minimum(dd, _days_in_month(y2, m2)))


def _date_add(unit: str):
    def impl(n, x):
        if unit in ("day", "week"):
            k = 7 if unit == "week" else 1
            if _is_ts(x):
                return x + n.to(torch.int64) * (k * US_DAY)
            return (x + n.to(x.dtype) * k).to(x.dtype)
        if unit in _MONTHS_OF:
            months = n * _MONTHS_OF[unit]
            if _is_ts(x):
                return (_add_months_days(_ts_days(x), months)
                        .to(torch.int64) * US_DAY
                        + torch.remainder(x, US_DAY))
            return _add_months_days(x, months).to(x.dtype)
        return x + n.to(torch.int64) * _US_OF[unit]
    return impl


def _date_diff(unit: str):
    def impl(a, b):
        if unit in ("day", "week"):
            if _is_ts(a):
                d = _fdiv(b, US_DAY) - _fdiv(a, US_DAY)
            else:
                d = (b - a).to(torch.int64)
            return (_fdiv(d, 7) if unit == "week" else d).to(torch.int64)
        if unit in _MONTHS_OF:
            ya, ma, da = _civil_from_days(_ts_days(a) if _is_ts(a) else a)
            yb, mb, db = _civil_from_days(_ts_days(b) if _is_ts(b) else b)
            # a partial month does not count
            months = (yb - ya) * 12 + (mb - ma) - (db < da).to(ya.dtype)
            return _fdiv(months, _MONTHS_OF[unit]).to(torch.int64)
        return _fdiv(b - a, _US_OF[unit]).to(torch.int64)
    return impl


for _u in ("second", "minute", "hour", "day", "week", "month", "quarter",
           "year"):
    register_function(ScalarFunction(
        f"__date_trunc_{_u}", lambda a: a[0], _date_trunc(_u)))
for _u in ("day", "week", "month", "quarter", "year", "hour", "minute",
           "second", "millisecond"):
    register_function(ScalarFunction(
        f"__date_add_{_u}", lambda a: a[1], _date_add(_u),
        promote_args=False))
    register_function(ScalarFunction(
        f"__date_diff_{_u}", lambda a: BIGINT, _date_diff(_u),
        promote_args=False))
