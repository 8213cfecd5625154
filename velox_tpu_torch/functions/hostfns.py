"""Host-evaluated value functions: regex, datetime formatting, JSON, URL,
hashes and codecs, IP and the string additions.

The port's own copy of the JAX package's ``functions/hostfns.py``: the
per-distinct-value halves of the bind-time dictionary transforms
(``expr/compiler.py`` ``bind_strings``). Each function runs once per
distinct dictionary value (or per value of a bounded integer range) on
the host, and the device sees one table gather. The reference's
Re2Functions (velox/functions/lib/Re2Functions.h), DateTimeFormatter
(velox/functions/lib/DateTimeFormatter/), the JSON functions
(velox/functions/prestosql/json/) and URLFunctions
(velox/functions/prestosql/URLFunctions.h) land here.

It needs the standard library only: XXH64 and XXH3-128 are written out
in Python below, so no ``xxhash`` package is needed. The readers of
t-digest and q-digest blobs (``value_at_quantile``,
``quantile_at_value``) wait for the port of ``functions/digest.py``.
"""

from __future__ import annotations

import datetime as _dt
import functools
import json
import re
from typing import Optional
from urllib.parse import urlparse


# ------------------------------------------------------------------ regex

#: Java \p{...} / POSIX-in-class names -> Python character classes
#: (velox/functions/lib/Re2Functions.h semantics bar; RE2's own table
#: is re2/unicode_groups; only the names Presto docs use are mapped)
_JAVA_CLASSES = {
    "Alpha": "a-zA-Z", "Digit": "0-9", "Alnum": "a-zA-Z0-9",
    "Upper": "A-Z", "Lower": "a-z", "Space": r" \t\n\x0b\f\r",
    "Blank": r" \t", "Punct": r"!-/:-@\[-`{-~",
    "XDigit": "0-9a-fA-F", "ASCII": r"\x00-\x7f",
    "Graph": r"\x21-\x7e", "Print": r"\x20-\x7e",
    "Cntrl": r"\x00-\x1f\x7f",
    # Unicode one-letter categories (approximated with Python's
    # perl-class complements where exact sets would need unicodedata)
    "L": r"^\W\d_", "Lu": "A-Z", "Ll": "a-z",
    "N": r"0-9", "Nd": "0-9",
}


_H_SPACE = ("[ \\t\\xa0\\u1680\\u2000-\\u200a"
            "\\u202f\\u205f\\u3000]")
_V_SPACE = "[\\n\\x0b\\f\\r\\x85\\u2028\\u2029]"


def _java_regex(pattern: str) -> str:
    """Translate Java (Presto) regex syntax to Python ``re``.

    Python 3.12 natively supports possessive quantifiers and atomic
    groups, so the remaining divergences are: ``\\p{...}``/``\\P{...}``
    property classes, POSIX ``[[:name:]]`` classes, ``\\h``/``\\H``
    horizontal and ``\\v``/``\\V`` vertical whitespace, and
    ``\\Q...\\E`` literal quoting
    (velox/functions/lib/Re2Functions.h is the semantics bar)."""
    out = []
    i = 0
    n = len(pattern)
    while i < n:
        ch = pattern[i]
        if ch == "\\" and i + 1 < n:
            nxt = pattern[i + 1]
            if nxt in "pP" and i + 2 < n and pattern[i + 2] == "{":
                end = pattern.find("}", i + 3)
                if end > 0:
                    cls = _JAVA_CLASSES.get(pattern[i + 3: end])
                    if cls is not None:
                        neg = (nxt == "P") != cls.startswith("^")
                        body = cls.lstrip("^")
                        out.append(f"[{'^' if neg else ''}{body}]")
                        i = end + 1
                        continue
            if nxt == "Q":  # \Q ... \E literal span
                end = pattern.find(r"\E", i + 2)
                lit = pattern[i + 2: end if end >= 0 else n]
                out.append(re.escape(lit))
                i = (end + 2) if end >= 0 else n
                continue
            if nxt == "h":
                out.append(_H_SPACE)
                i += 2
                continue
            if nxt == "H":
                out.append(_H_SPACE.replace("[", "[^", 1))
                i += 2
                continue
            if nxt == "v":
                out.append(_V_SPACE)
                i += 2
                continue
            if nxt == "V":
                out.append(_V_SPACE.replace("[", "[^", 1))
                i += 2
                continue
            out.append(pattern[i: i + 2])
            i += 2
            continue
        if ch == "[" and pattern.startswith("[:", i + 1):
            # POSIX class inside brackets: [[:alpha:][:digit:]] etc.
            end = pattern.find("]", i + 1)
            # rebuild the bracket expression replacing [:name:] parts
            j = i + 1
            body = []
            neg = ""
            if j < n and pattern[j] == "^":
                neg = "^"
                j += 1
            while j < n and pattern[j] != "]":
                if pattern.startswith("[:", j):
                    pend = pattern.find(":]", j + 2)
                    if pend > 0:
                        nm = pattern[j + 2: pend].capitalize()
                        nm = {"Xdigit": "XDigit", "Ascii": "ASCII"}.get(
                            nm, nm)
                        body.append(_JAVA_CLASSES.get(nm, ""))
                        j = pend + 2
                        continue
                if pattern[j] == "\\" and j + 1 < n:
                    body.append(pattern[j: j + 2])
                    j += 2
                    continue
                body.append(pattern[j])
                j += 1
            out.append(f"[{neg}{''.join(body)}]")
            i = j + 1
            continue
        out.append(ch)
        i += 1
    return "".join(out)


@functools.lru_cache(maxsize=256)
def _java_rx(pattern: str) -> "re.Pattern":
    """The compiled translation of ``pattern``: a function that runs once
    per dictionary value translates and compiles its pattern once."""
    return re.compile(_java_regex(pattern))


def regexp_like(s: str, pattern: str) -> bool:
    return _java_rx(pattern).search(s) is not None


def regexp_extract(s: str, pattern: str, group: int = 0) -> Optional[str]:
    m = _java_rx(pattern).search(s)
    if m is None:
        return None
    try:
        return m.group(group)
    except IndexError:
        return None


def regexp_replace(s: str, pattern: str, repl: str = "") -> str:
    # Presto replacement groups are $1/$g; re wants \1/\g
    py_repl = re.sub(r"\$(\d+)", r"\\\1", repl)
    return _java_rx(pattern).sub(py_repl, s)


def regexp_count(s: str, pattern: str) -> int:
    return len(_java_rx(pattern).findall(s))


def regexp_position(s: str, pattern: str) -> int:
    m = _java_rx(pattern).search(s)
    return (m.start() + 1) if m else -1


# --------------------------------------------------------------- datetime

#: MySQL date_format specifiers (velox/functions/lib/DateTimeFormatter/
#: DateTimeFormatterBuilder.h buildMysqlDateTimeFormatter)
_MYSQL_MAP = {
    "%Y": "%Y", "%y": "%y", "%m": "%m", "%c": "%-m", "%d": "%d",
    "%e": "%-d", "%H": "%H", "%k": "%-H", "%i": "%M", "%s": "%S",
    "%S": "%S", "%f": "%f", "%p": "%p", "%W": "%A", "%a": "%a",
    "%M": "%B", "%b": "%b", "%j": "%j", "%T": "%H:%M:%S", "%%": "%%",
}

#: Joda-style tokens for format_datetime/parse_datetime
#: (velox/functions/lib/DateTimeFormatter buildJodaDateTimeFormatter)
_JODA_TOKENS = [
    ("yyyy", "%Y"), ("yyy", "%Y"), ("yy", "%y"), ("MM", "%m"),
    ("M", "%-m"), ("dd", "%d"), ("d", "%-d"), ("HH", "%H"), ("H", "%-H"),
    ("mm", "%M"), ("m", "%-M"), ("ss", "%S"), ("s", "%-S"),
    ("SSS", "%f"), ("EEEE", "%A"), ("EEE", "%a"), ("MMMM", "%B"),
    ("MMM", "%b"), ("a", "%p"), ("DDD", "%j"),
]


def _mysql_to_strftime(fmt: str) -> str:
    out = []
    i = 0
    while i < len(fmt):
        if fmt[i] == "%" and i + 1 < len(fmt):
            tok = fmt[i:i + 2]
            out.append(_MYSQL_MAP.get(tok, tok[1]))
            i += 2
        else:
            out.append(fmt[i])
            i += 1
    return "".join(out)


def _joda_to_strftime(fmt: str) -> str:
    out = []
    i = 0
    while i < len(fmt):
        if fmt[i] == "'":  # joda literal quoting
            j = fmt.find("'", i + 1)
            if j == i + 1:
                out.append("'")
                i += 2
                continue
            out.append(fmt[i + 1: j if j > 0 else len(fmt)])
            i = (j + 1) if j > 0 else len(fmt)
            continue
        for tok, py in _JODA_TOKENS:
            if fmt.startswith(tok, i):
                out.append(py)
                i += len(tok)
                break
        else:
            out.append(fmt[i])
            i += 1
    return "".join(out)


_EPOCH = _dt.datetime(1970, 1, 1)


def _from_days(days: int) -> _dt.datetime:
    return _EPOCH + _dt.timedelta(days=int(days))


def _from_micros(us: int) -> _dt.datetime:
    return _EPOCH + _dt.timedelta(microseconds=int(us))


def date_format_days(days: int, fmt: str) -> str:
    """date_format over a DATE lane (days since epoch)."""
    return _strftime(_from_days(days), _mysql_to_strftime(fmt))


def date_format_micros(us: int, fmt: str) -> str:
    return _strftime(_from_micros(us), _mysql_to_strftime(fmt))


def format_datetime_days(days: int, fmt: str) -> str:
    return _strftime(_from_days(days), _joda_to_strftime(fmt))


def format_datetime_micros(us: int, fmt: str) -> str:
    return _strftime(_from_micros(us), _joda_to_strftime(fmt))


def _strftime(dt: _dt.datetime, pyfmt: str) -> str:
    # %-m style (no zero pad) is glibc-only; emulate portably
    out = []
    i = 0
    while i < len(pyfmt):
        if pyfmt.startswith("%-", i) and i + 2 < len(pyfmt) + 1:
            c = pyfmt[i + 2]
            out.append(str(int(dt.strftime("%" + c))))
            i += 3
        else:
            if pyfmt[i] == "%" and i + 1 < len(pyfmt):
                out.append(dt.strftime(pyfmt[i:i + 2]))
                i += 2
            else:
                out.append(pyfmt[i])
                i += 1
    return "".join(out)


def parse_datetime_micros(s: str, fmt: str) -> Optional[int]:
    """parse_datetime(varchar, joda fmt) -> microseconds since epoch."""
    pyfmt = _joda_to_strftime(fmt).replace("%-", "%")
    try:
        dt = _dt.datetime.strptime(s, pyfmt)
    except ValueError:
        return None
    return int((dt - _EPOCH).total_seconds() * 1_000_000)


def from_iso8601_date_days(s: str) -> Optional[int]:
    try:
        return (_dt.date.fromisoformat(s.strip())
                - _dt.date(1970, 1, 1)).days
    except ValueError:
        return None


def from_iso8601_timestamp_micros(s: str) -> Optional[int]:
    try:
        dt = _dt.datetime.fromisoformat(s.strip().replace("Z", "+00:00"))
    except ValueError:
        return None
    if dt.tzinfo is not None:
        dt = dt.astimezone(_dt.timezone.utc).replace(tzinfo=None)
    return int((dt - _EPOCH).total_seconds() * 1_000_000)


# ------------------------------------------------------------------- JSON

def _json_path_get(doc, path: str):
    """Minimal JSONPath: $.a.b[0].c / $["a b"] (velox SIMDJsonFunctions
    jsonExtract supported subset)."""
    if not path.startswith("$"):
        return None
    i = 1
    cur = doc
    while i < len(path) and cur is not None:
        if path[i] == ".":
            j = i + 1
            while j < len(path) and path[j] not in ".[":
                j += 1
            key = path[i + 1: j]
            cur = cur.get(key) if isinstance(cur, dict) else None
            i = j
        elif path[i] == "[":
            j = path.find("]", i)
            if j < 0:
                return None
            token = path[i + 1: j].strip()
            if token[:1] in ("'", '"'):
                key = token[1:-1]
                cur = cur.get(key) if isinstance(cur, dict) else None
            else:
                try:
                    idx = int(token)
                except ValueError:
                    return None
                cur = (cur[idx] if isinstance(cur, list)
                       and -len(cur) <= idx < len(cur) else None)
            i = j + 1
        else:
            return None
    return cur


def json_extract_scalar(j: str, path: str) -> Optional[str]:
    try:
        doc = json.loads(j)
    except (ValueError, TypeError):
        return None
    v = _json_path_get(doc, path)
    if v is None or isinstance(v, (dict, list)):
        return None
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and v == int(v):
        return str(v)
    return str(v)


def json_extract(j: str, path: str) -> Optional[str]:
    try:
        doc = json.loads(j)
    except (ValueError, TypeError):
        return None
    v = _json_path_get(doc, path)
    if v is None:
        return None
    return json.dumps(v, separators=(",", ":"))


def json_array_length(j: str) -> Optional[int]:
    try:
        doc = json.loads(j)
    except (ValueError, TypeError):
        return None
    return len(doc) if isinstance(doc, list) else None


def json_size(j: str, path: str) -> Optional[int]:
    try:
        doc = json.loads(j)
    except (ValueError, TypeError):
        return None
    v = _json_path_get(doc, path)
    if isinstance(v, (dict, list)):
        return len(v)
    return 0 if v is not None else None


def is_json_scalar(j: str) -> Optional[bool]:
    try:
        doc = json.loads(j)
    except (ValueError, TypeError):
        return None
    return not isinstance(doc, (dict, list))


# -------------------------------------------------------------------- URL

def _parse_url(u: str):
    """None for strings Java's URI would reject (no scheme or spaces) —
    presto URL functions return NULL on invalid URLs."""
    if " " in u:
        return None
    p = urlparse(u)
    if not p.scheme:
        return None
    return p


def url_extract_host(u: str) -> Optional[str]:
    p = _parse_url(u)
    return (p.hostname or None) if p else None


def url_extract_protocol(u: str) -> Optional[str]:
    p = _parse_url(u)
    return (p.scheme or None) if p else None


def url_extract_path(u: str) -> Optional[str]:
    p = _parse_url(u)
    return (p.path or None) if p else None


def url_extract_query(u: str) -> Optional[str]:
    p = _parse_url(u)
    return (p.query or None) if p else None


def url_extract_fragment(u: str) -> Optional[str]:
    p = _parse_url(u)
    return (p.fragment or None) if p else None


def url_extract_port(u: str) -> Optional[int]:
    p = _parse_url(u)
    if p is None:
        return None
    try:
        return p.port
    except ValueError:
        return None


def url_extract_parameter(u: str, name: str) -> Optional[str]:
    from urllib.parse import parse_qs

    p = _parse_url(u)
    if p is None:
        return None
    q = parse_qs(p.query, keep_blank_values=True)
    vals = q.get(name)
    return vals[0] if vals else None


# ------------------------------------------------------------- misc string

def levenshtein_distance(a: str, b: str) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def hamming_distance(a: str, b: str) -> Optional[int]:
    if len(a) != len(b):
        return None  # presto raises; null under TRY semantics
    return sum(x != y for x, y in zip(a, b))


def to_hex_str(s: str) -> str:
    return s.encode("utf-8").hex().upper()


def md5_hex(s: str) -> str:
    import hashlib

    return hashlib.md5(s.encode("utf-8")).hexdigest()


def sha256_hex(s: str) -> str:
    import hashlib

    return hashlib.sha256(s.encode("utf-8")).hexdigest()


def crc32_int(s: str) -> int:
    import zlib

    return zlib.crc32(s.encode("utf-8"))


def codepoint_int(s: str) -> Optional[int]:
    return ord(s[0]) if s else None


def normalize_nfc(s: str, form: str = "NFC") -> str:
    import unicodedata

    return unicodedata.normalize(form.upper(), s)


def word_stem_en(s: str, lang: str = "en") -> str:
    """Tiny Porter-lite stemmer (suffix stripping) — the common cases of
    velox's word_stem without an external stemmer library."""
    for suf in ("ingly", "edly", "ing", "ed", "ies", "es", "s", "ly"):
        if s.endswith(suf) and len(s) - len(suf) >= 3:
            base = s[: -len(suf)]
            if suf == "ies":
                return base + "y"
            return base
    return s


def octet_length(s: str) -> int:
    """UTF-8 byte length (prestosql octet_length)."""
    return len(s.encode("utf-8"))


# --------------------------------------------------------- IP functions
# velox/functions/prestosql/IPAddressFunctions.cpp. IPADDRESS/IPPREFIX
# are represented as canonical VARCHAR strings here (documented
# deviation: no dedicated binary type kind); invalid inputs -> None
# (the host-fn family's error convention, vs the reference's throw).

def _ip_net(prefix: str):
    import ipaddress

    return ipaddress.ip_network(prefix.strip(), strict=False)


def ip_prefix(ip: str, bits) -> "str | None":
    """Canonical prefix of an address: ip_prefix('1.2.3.4', 24) ->
    '1.2.3.0/24'."""
    try:
        net = _ip_net(f"{ip}/{int(bits)}")
        return f"{net.network_address}/{net.prefixlen}"
    except ValueError:
        return None


def ip_subnet_min(prefix: str) -> "str | None":
    try:
        return str(_ip_net(prefix).network_address)
    except ValueError:
        return None


def ip_subnet_max(prefix: str) -> "str | None":
    try:
        return str(_ip_net(prefix).broadcast_address)
    except ValueError:
        return None


def is_subnet_of(prefix: str, target: str) -> "bool | None":
    """is_subnet_of(prefix, ip) and is_subnet_of(prefix, prefix).
    Mixed address families are False (a v6 address is never inside a
    v4 prefix — Presto maps v4 into v6 space, where they also never
    overlap); only unparseable inputs are None."""
    import ipaddress

    try:
        net = _ip_net(prefix)
        t = target.strip()
        if "/" in t:
            sub = ipaddress.ip_network(t, strict=False)
            if sub.version != net.version:
                return False
            return sub.subnet_of(net)
        a = ipaddress.ip_address(t)
        if a.version != net.version:
            return False
        return net.network_address <= a <= net.broadcast_address
    except ValueError:
        return None


def is_private_ip(ip: str) -> "bool | None":
    import ipaddress

    try:
        return ipaddress.ip_address(ip.strip()).is_private
    except ValueError:
        return None


# ----------------------------------------------------- binary functions
# velox/functions/prestosql/BinaryFunctions.h. VARBINARY rides VARCHAR
# dictionary columns; byte payloads are represented as the reference's
# canonical presentation forms (hex upper for to_hex, base64 text,
# utf-8 passthrough for to_utf8/from_utf8 — documented deviation from
# true binary lanes).

def sha1_hex(s: str) -> str:
    import hashlib

    return hashlib.sha1(s.encode()).hexdigest()


def sha512_hex(s: str) -> str:
    import hashlib

    return hashlib.sha512(s.encode()).hexdigest()


def xxhash64_hex(s: str) -> str:
    """xxhash64(varbinary) -> varbinary: XXH64 with seed 0, big-endian
    hex."""
    return _xxh64_int(s.encode()).to_bytes(8, "big").hex()


def _xxh64_int(data: bytes) -> int:
    """XXH64 of ``data`` with seed 0, as an unsigned 64-bit integer."""
    p1, p2, p3, p4, p5 = (
        11400714785074694791, 14029467366897019727, 1609587929392839161,
        9650029242287828579, 2870177450012600261)
    mask = (1 << 64) - 1

    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & mask

    n = len(data)
    if n >= 32:
        v1 = (p1 + p2) & mask
        v2 = p2
        v3 = 0
        v4 = (-p1) & mask
        i = 0
        while i + 32 <= n:
            for j, v in enumerate((v1, v2, v3, v4)):
                lane = int.from_bytes(data[i + 8 * j: i + 8 * j + 8],
                                      "little")
                v = (v + lane * p2) & mask
                v = rotl(v, 31)
                v = (v * p1) & mask
                if j == 0:
                    v1 = v
                elif j == 1:
                    v2 = v
                elif j == 2:
                    v3 = v
                else:
                    v4 = v
            i += 32
        h = (rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12)
             + rotl(v4, 18)) & mask
        for v in (v1, v2, v3, v4):
            v = (v * p2) & mask
            v = rotl(v, 31)
            v = (v * p1) & mask
            h = ((h ^ v) * p1 + p4) & mask
    else:
        h = (p5) & mask
        i = 0
    h = (h + n) & mask
    while i + 8 <= n:
        lane = int.from_bytes(data[i: i + 8], "little")
        k = (lane * p2) & mask
        k = rotl(k, 31)
        k = (k * p1) & mask
        h = (rotl(h ^ k, 27) * p1 + p4) & mask
        i += 8
    if i + 4 <= n:
        lane = int.from_bytes(data[i: i + 4], "little")
        h = (rotl(h ^ ((lane * p1) & mask), 23) * p2 + p3) & mask
        i += 4
    while i < n:
        h = (rotl(h ^ ((data[i] * p5) & mask), 11) * p1) & mask
        i += 1
    h ^= h >> 33
    h = (h * p2) & mask
    h ^= h >> 29
    h = (h * p3) & mask
    h ^= h >> 32
    return h


def _hmac_hex(algo: str):
    def fn(s: str, key: str) -> str:
        import hashlib
        import hmac as _hmac

        return _hmac.new(key.encode(), s.encode(), algo).hexdigest()
    return fn


hmac_sha1 = _hmac_hex("sha1")
hmac_sha256 = _hmac_hex("sha256")
hmac_sha512 = _hmac_hex("sha512")
hmac_md5 = _hmac_hex("md5")


def to_hex(s: str) -> str:
    return s.encode().hex().upper()


def from_hex(s: str) -> "str | None":
    try:
        return bytes.fromhex(s).decode("utf-8", errors="replace")
    except ValueError:
        return None


def to_base64(s: str) -> str:
    import base64

    return base64.b64encode(s.encode()).decode()


def from_base64(s: str) -> "str | None":
    import base64

    try:
        pad = s + "=" * (-len(s) % 4)
        return base64.b64decode(pad).decode("utf-8", errors="replace")
    except Exception:
        return None


def to_base64url(s: str) -> str:
    import base64

    return base64.urlsafe_b64encode(s.encode()).decode()


def from_base64url(s: str) -> "str | None":
    import base64

    try:
        pad = s + "=" * (-len(s) % 4)
        return base64.urlsafe_b64decode(pad).decode(
            "utf-8", errors="replace")
    except Exception:
        return None


def to_base32(s: str) -> str:
    import base64

    return base64.b32encode(s.encode()).decode()


def from_base32(s: str) -> "str | None":
    import base64

    try:
        pad = s + "=" * (-len(s) % 8)
        return base64.b32decode(pad).decode("utf-8", errors="replace")
    except Exception:
        return None


def from_utf8(s: str) -> str:
    return s  # varbinary rides varchar lanes (module docstring)


def to_utf8(s: str) -> str:
    return s


def from_base(s: str, radix: int) -> "int | None":
    """from_base(varchar, radix) -> bigint (StringFunctions.h)."""
    try:
        return int(s.strip(), int(radix))
    except (ValueError, TypeError):
        return None


# ------------------------------------------------- string additions
# velox/functions/prestosql/StringFunctions.h

def soundex(s: str) -> str:
    s = s.strip()
    if not s or not s[0].isalpha():
        return s
    codes = {**dict.fromkeys("BFPV", "1"),
             **dict.fromkeys("CGJKQSXZ", "2"),
             **dict.fromkeys("DT", "3"), "L": "4",
             **dict.fromkeys("MN", "5"), "R": "6"}
    up = s.upper()
    out = [up[0]]
    prev = codes.get(up[0], "")
    for ch in up[1:]:
        c = codes.get(ch, "")
        if c and c != prev:
            out.append(c)
        if ch not in "HW":
            prev = c
        if len(out) == 4:
            break
    return ("".join(out) + "000")[:4]


def translate3(s: str, frm: str, to: str) -> str:
    table = {}
    for i, ch in enumerate(frm):
        if ch in table:
            continue
        table[ch] = to[i] if i < len(to) else None
    out = []
    for ch in s:
        if ch in table:
            if table[ch] is not None:
                out.append(table[ch])
        else:
            out.append(ch)
    return "".join(out)


def trim_chars(s: str, chars: str) -> str:
    return s.strip(chars)


def ltrim_chars(s: str, chars: str) -> str:
    return s.lstrip(chars)


def rtrim_chars(s: str, chars: str) -> str:
    return s.rstrip(chars)


def luhn_check(s: str) -> "bool | None":
    if not s.isdigit():
        return None
    total = 0
    for i, ch in enumerate(reversed(s)):
        d = int(ch)
        if i % 2 == 1:
            d *= 2
            if d > 9:
                d -= 9
        total += d
    return total % 10 == 0


def url_encode(s: str) -> str:
    from urllib.parse import quote_plus

    return quote_plus(s)


def url_decode(s: str) -> "str | None":
    from urllib.parse import unquote_plus

    try:
        return unquote_plus(s)
    except Exception:
        return None


# ------------------------------------------------- JSON additions
# velox/functions/prestosql/JsonFunctions.h

def json_parse(s: str) -> "str | None":
    """Canonicalize (Presto json_parse output form: compact, sorted
    keys like the reference's canonicalization)."""
    try:
        return json.dumps(json.loads(s), separators=(",", ":"),
                          sort_keys=True)
    except (ValueError, TypeError):
        return None


def json_format(s: str) -> "str | None":
    try:
        return json.dumps(json.loads(s), separators=(",", ":"))
    except (ValueError, TypeError):
        return None


def json_array_contains(s: str, value) -> "bool | None":
    try:
        arr = json.loads(s)
    except (ValueError, TypeError):
        return None
    if not isinstance(arr, list):
        return None
    if isinstance(value, str) and value.startswith("'"):
        value = value.strip("'")
    for e in arr:
        if e == value:
            return True
        if (isinstance(e, (int, float))
                and isinstance(value, (int, float)) and e == value):
            return True
    return False


def json_array_get(s: str, index: int) -> "str | None":
    try:
        arr = json.loads(s)
    except (ValueError, TypeError):
        return None
    if not isinstance(arr, list):
        return None
    i = int(index)
    if i < 0:
        i += len(arr)
    if not 0 <= i < len(arr):
        return None
    e = arr[i]
    if isinstance(e, str):
        return e
    return json.dumps(e, separators=(",", ":"))


def murmur3_x64_128_hex(s: str) -> str:
    """murmur3_x64_128(varbinary) -> 16-byte hex
    (velox/functions/prestosql/BinaryFunctions.h; reference algorithm
    reimplemented, seed 0)."""
    data = s.encode()
    mask = (1 << 64) - 1
    c1, c2 = 0x87C37B91114253D5, 0x4CF5AD432745937F

    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & mask

    def fmix(k):
        k ^= k >> 33
        k = (k * 0xFF51AFD7ED558CCD) & mask
        k ^= k >> 33
        k = (k * 0xC4CEB9FE1A85EC53) & mask
        return k ^ (k >> 33)

    h1 = h2 = 0
    n = len(data)
    nblocks = n // 16
    for i in range(nblocks):
        k1 = int.from_bytes(data[16 * i: 16 * i + 8], "little")
        k2 = int.from_bytes(data[16 * i + 8: 16 * i + 16], "little")
        k1 = (k1 * c1) & mask
        k1 = rotl(k1, 31)
        k1 = (k1 * c2) & mask
        h1 ^= k1
        h1 = rotl(h1, 27)
        h1 = (h1 + h2) & mask
        h1 = (h1 * 5 + 0x52DCE729) & mask
        k2 = (k2 * c2) & mask
        k2 = rotl(k2, 33)
        k2 = (k2 * c1) & mask
        h2 ^= k2
        h2 = rotl(h2, 31)
        h2 = (h2 + h1) & mask
        h2 = (h2 * 5 + 0x38495AB5) & mask
    tail = data[nblocks * 16:]
    k1 = k2 = 0
    if len(tail) > 8:
        k2 = int.from_bytes(tail[8:].ljust(8, b"\0"), "little")
        k2 = (k2 * c2) & mask
        k2 = rotl(k2, 33)
        k2 = (k2 * c1) & mask
        h2 ^= k2
    if tail:
        k1 = int.from_bytes(tail[:8].ljust(8, b"\0"), "little")
        k1 = (k1 * c1) & mask
        k1 = rotl(k1, 31)
        k1 = (k1 * c2) & mask
        h1 ^= k1
    h1 ^= n
    h2 ^= n
    h1 = (h1 + h2) & mask
    h2 = (h2 + h1) & mask
    h1 = fmix(h1)
    h2 = fmix(h2)
    h1 = (h1 + h2) & mask
    h2 = (h2 + h1) & mask
    return (h1.to_bytes(8, "little") + h2.to_bytes(8, "little")).hex()


# ---------------------------------------- round-3 string breadth
# velox/functions/prestosql/StringFunctions.h additions.

def bit_length_int(s: str) -> int:
    return len(s.encode()) * 8


def strrpos(s: str, sub: str, instance: int = 1) -> int:
    """1-based position of the instance-th occurrence of ``sub``
    counting from the END (StringFunctions.h StrRPosFunction)."""
    if not sub:
        return 0
    n = int(instance)
    pos = len(s)
    while n > 0:
        pos = s.rfind(sub, 0, pos + len(sub) - 1)
        if pos < 0:
            return 0
        n -= 1
    return pos + 1


def replace_first3(s: str, search: str, repl: str) -> str:
    return s.replace(search, repl, 1)


def longest_common_prefix2(a: str, b: str) -> str:
    import os.path

    return os.path.commonprefix([a, b])


def jarowinkler_similarity2(a: str, b: str) -> "float | None":
    """Jaro-Winkler similarity (StringFunctions.h
    JaroWinklerSimilarityFunction; scaling factor 0.1, standard
    4-char prefix bound)."""
    if not a or not b:
        return None if (not a and not b) else 0.0
    if a == b:
        return 1.0
    la, lb = len(a), len(b)
    window = max(la, lb) // 2 - 1
    amatch = [False] * la
    bmatch = [False] * lb
    m = 0
    for i, ca in enumerate(a):
        lo = max(0, i - window)
        hi = min(lb, i + window + 1)
        for j in range(lo, hi):
            if not bmatch[j] and ca == b[j]:
                amatch[i] = bmatch[j] = True
                m += 1
                break
    if m == 0:
        return 0.0
    t = 0
    j = 0
    for i in range(la):
        if amatch[i]:
            while not bmatch[j]:
                j += 1
            if a[i] != b[j]:
                t += 1
            j += 1
    jaro = (m / la + m / lb + (m - t / 2) / m) / 3.0
    prefix = 0
    for ca, cb in zip(a, b):
        if ca != cb or prefix == 4:
            break
        prefix += 1
    return jaro + prefix * 0.1 * (1.0 - jaro)


def trail_n(s: str, n: int) -> str:
    n = int(n)
    return s[-n:] if n > 0 else ""


def key_sampling_percent(s: str) -> float:
    """XXH64 bits reinterpreted as an IEEE double, |x| mod 100 / 100
    (StringFunctions.h KeySamplingPercentFunction — Java
    Double.longBitsToDouble semantics; NaN is an allowed result)."""
    import math
    import struct

    h = _xxh64_int(s.encode())
    d = struct.unpack("<d", struct.pack("<q", h - (1 << 64)
                                        if h >= (1 << 63) else h))[0]
    return math.fmod(abs(d), 100.0) / 100.0


# --------------------------------------- round-3 datetime breadth
# velox/functions/prestosql/DateTimeFunctions.h date_parse (MySQL
# format) / parse_duration / to_milliseconds. Intervals are BIGINT
# millisecond lanes — velox's own IntervalDayTime physical rep.

#: MySQL format specifier -> Python strptime (DateTimeFunctions.h
#: date_parse; the MySQL subset Presto documents)
_MYSQL_STRPTIME = {
    "Y": "%Y", "y": "%y", "m": "%m", "c": "%m", "d": "%d", "e": "%d",
    "H": "%H", "k": "%H", "h": "%I", "I": "%I", "i": "%M", "s": "%S",
    "S": "%S", "f": "%f", "p": "%p", "M": "%B", "b": "%b", "a": "%a",
    "W": "%A", "j": "%j", "T": "%H:%M:%S", "r": "%I:%M:%S %p",
    "%": "%%",
}


def date_parse_micros(s: str, fmt: str) -> "int | None":
    out = []
    i = 0
    while i < len(fmt):
        ch = fmt[i]
        if ch == "%" and i + 1 < len(fmt):
            py = _MYSQL_STRPTIME.get(fmt[i + 1])
            if py is None:
                return None
            out.append(py)
            i += 2
        else:
            out.append(ch)
            i += 1
    try:
        dt = _dt.datetime.strptime(s, "".join(out))
    except ValueError:
        return None
    delta = dt - _dt.datetime(1970, 1, 1)
    return ((delta.days * 86400 + delta.seconds) * 1_000_000
            + delta.microseconds)


_DURATION_UNITS_MS = {
    "ns": 1e-6, "us": 1e-3, "ms": 1.0, "s": 1e3,
    "m": 60e3, "h": 3600e3, "d": 86400e3,
}


def parse_duration_ms(s: str) -> "int | None":
    """parse_duration('3.4 m') -> interval millis (DateTimeFunctions.h
    ParseDurationFunction; interval = BIGINT ms lane)."""
    m = re.fullmatch(r"\s*(\d+(?:\.\d+)?)\s*([a-zA-Z]+)\s*", s)
    if not m:
        return None
    unit = _DURATION_UNITS_MS.get(m.group(2))
    if unit is None:
        return None
    return int(round(float(m.group(1)) * unit))


_DATA_SIZE_UNITS = {
    "B": 1, "kB": 1 << 10, "MB": 1 << 20, "GB": 1 << 30,
    "TB": 1 << 40, "PB": 1 << 50, "EB": 1 << 60,
    "ZB": 1 << 70, "YB": 1 << 80,
}


def parse_presto_data_size_int(s: str) -> "int | None":
    """parse_presto_data_size('2.3MB') -> bytes
    (velox/functions/prestosql/DataSizeFunctions.cpp; the reference
    returns DECIMAL(38,0) — here a BIGINT lane, exact for any size
    below 8 EiB)."""
    m = re.fullmatch(r"\s*(\d+(?:\.\d+)?)\s*([a-zA-Z]+)\s*", s)
    if not m:
        return None
    unit = _DATA_SIZE_UNITS.get(m.group(2))
    if unit is None:
        return None
    from decimal import Decimal

    return int(Decimal(m.group(1)) * unit)


# --------------------------------------- round-3 binary breadth
# velox/functions/prestosql/BinaryFunctions.h: FNV, big-endian /
# IEEE754 codecs, SpookyHashV2, XXH3-128. Binary values ride the
# string-dictionary lanes; hash outputs use the hex canonical form
# (same convention as to_hex/xxhash64 above).

def fnv1_32(s: str) -> int:
    h = 0x811C9DC5
    for b in s.encode():
        h = (h * 0x01000193) & 0xFFFFFFFF
        h ^= b
    return h - (1 << 32) if h >= (1 << 31) else h


def fnv1_64(s: str) -> int:
    h = 0xCBF29CE484222325
    for b in s.encode():
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
        h ^= b
    return h - (1 << 64) if h >= (1 << 63) else h


def fnv1a_32(s: str) -> int:
    h = 0x811C9DC5
    for b in s.encode():
        h ^= b
        h = (h * 0x01000193) & 0xFFFFFFFF
    return h - (1 << 32) if h >= (1 << 31) else h


def fnv1a_64(s: str) -> int:
    h = 0xCBF29CE484222325
    for b in s.encode():
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h - (1 << 64) if h >= (1 << 63) else h


def from_big_endian_32(s: str) -> "int | None":
    b = s.encode("utf-8", errors="replace")
    if len(b) != 4:
        return None
    return int.from_bytes(b, "big", signed=True)


def from_big_endian_64(s: str) -> "int | None":
    b = s.encode("utf-8", errors="replace")
    if len(b) != 8:
        return None
    return int.from_bytes(b, "big", signed=True)


def to_big_endian_32(v: int) -> str:
    return int(v).to_bytes(4, "big", signed=True).hex().upper()


def to_big_endian_64(v: int) -> str:
    return int(v).to_bytes(8, "big", signed=True).hex().upper()


def from_ieee754_32(s: str) -> "float | None":
    import struct

    b = s.encode("utf-8", errors="replace")
    if len(b) != 4:
        return None
    return float(struct.unpack(">f", b)[0])


def from_ieee754_64(s: str) -> "float | None":
    import struct

    b = s.encode("utf-8", errors="replace")
    if len(b) != 8:
        return None
    return struct.unpack(">d", b)[0]


def xxhash128_hex(s: str) -> str:
    """XXH3-128 with seed 0, big-endian canonical digest
    (BinaryFunctions.h XXHash128Function)."""
    lo, hi = _xxh3_128(s.encode())
    return (hi.to_bytes(8, "big") + lo.to_bytes(8, "big")).hex().upper()


# ---- XXH3-128 (xxhash 0.8, seed 0, default secret), written out from
# the published algorithm: one path for each input length class

_XXH3_SECRET = bytes.fromhex(
    "b8fe6c3923a44bbe7c01812cf721ad1cded46de9839097db7240a4a4b7b3671f"
    "cb79e64eccc0e578825ad07dccff7221b8084674f743248ee03590e6813a264c"
    "3c2852bb91c300cb88d0658b1b532ea371644897a20df94e3819ef46a9deacd8"
    "a8fa763fe39c343ff9dcbbc7c70b4f1d8a51e04bcdb45931c89f7ec9d9787364"
    "eac5ac8334d3ebc3c581a0fffa1363eb170ddd51b7f0da49d316552629d4689e"
    "2b16be587d47a1fc8ff8b8d17ad031ce45cb3a8f95160428afd7fbcabb4b407e")
_P32_1, _P32_2, _P32_3 = 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D
_P64_1, _P64_2, _P64_3 = (0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F,
                          0x165667B19E3779F9)
_P64_4, _P64_5 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5
_PMX1, _PMX2 = 0x165667919E3779F9, 0x9FB21C651E98DF25
_U64 = (1 << 64) - 1


def _r64(b: bytes, i: int) -> int:
    return int.from_bytes(b[i:i + 8], "little")


def _r32(b: bytes, i: int) -> int:
    return int.from_bytes(b[i:i + 4], "little")


def _xxh64_avalanche(h: int) -> int:
    h ^= h >> 33
    h = (h * _P64_2) & _U64
    h ^= h >> 29
    h = (h * _P64_3) & _U64
    return h ^ (h >> 32)


def _xxh3_avalanche(h: int) -> int:
    h ^= h >> 37
    h = (h * _PMX1) & _U64
    return h ^ (h >> 32)


def _mul128_fold64(a: int, b: int) -> int:
    p = a * b
    return (p ^ (p >> 64)) & _U64


def _mix16(data: bytes, i: int, k: int) -> int:
    return _mul128_fold64(_r64(data, i) ^ _r64(_XXH3_SECRET, k),
                          _r64(data, i + 8) ^ _r64(_XXH3_SECRET, k + 8))


def _mix32(lo: int, hi: int, data: bytes, i1: int, i2: int, k: int):
    lo = (lo + _mix16(data, i1, k)) & _U64
    lo ^= (_r64(data, i2) + _r64(data, i2 + 8)) & _U64
    hi = (hi + _mix16(data, i2, k + 16)) & _U64
    hi ^= (_r64(data, i1) + _r64(data, i1 + 8)) & _U64
    return lo, hi


def _xxh3_128_finish(lo: int, hi: int, n: int):
    h_lo = _xxh3_avalanche((lo + hi) & _U64)
    h_hi = (lo * _P64_1 + hi * _P64_4 + n * _P64_2) & _U64
    return h_lo, (-_xxh3_avalanche(h_hi)) & _U64


def _xxh3_128(data: bytes):
    """(low, high) 64-bit halves of XXH3-128(data, seed 0)."""
    n, k = len(data), _XXH3_SECRET
    if n == 0:
        return (_xxh64_avalanche(_r64(k, 64) ^ _r64(k, 72)),
                _xxh64_avalanche(_r64(k, 80) ^ _r64(k, 88)))
    if n <= 3:
        comb_l = ((data[0] << 16) | (data[n >> 1] << 24) | data[n - 1]
                  | (n << 8))
        swapped = int.from_bytes(comb_l.to_bytes(4, "little"), "big")
        comb_h = ((swapped << 13) | (swapped >> 19)) & 0xFFFFFFFF
        return (_xxh64_avalanche(comb_l ^ (_r32(k, 0) ^ _r32(k, 4))),
                _xxh64_avalanche(comb_h ^ (_r32(k, 8) ^ _r32(k, 12))))
    if n <= 8:
        x = _r32(data, 0) + (_r32(data, n - 4) << 32)
        keyed = x ^ (_r64(k, 16) ^ _r64(k, 24))
        p = keyed * ((_P64_1 + (n << 2)) & _U64)
        lo, hi = p & _U64, p >> 64
        hi = (hi + (lo << 1)) & _U64
        lo ^= hi >> 3
        lo ^= lo >> 35
        lo = (lo * _PMX2) & _U64
        lo ^= lo >> 28
        return lo, _xxh3_avalanche(hi)
    if n <= 16:
        x_lo, x_hi = _r64(data, 0), _r64(data, n - 8)
        p = (x_lo ^ x_hi ^ (_r64(k, 32) ^ _r64(k, 40))) * _P64_1
        lo, hi = p & _U64, p >> 64
        lo = (lo + ((n - 1) << 54)) & _U64
        x_hi ^= _r64(k, 48) ^ _r64(k, 56)
        hi = (hi + x_hi + (x_hi & 0xFFFFFFFF) * (_P32_2 - 1)) & _U64
        lo ^= int.from_bytes(hi.to_bytes(8, "little"), "big")
        p = lo * _P64_2
        h_lo, h_hi = p & _U64, ((p >> 64) + hi * _P64_2) & _U64
        return _xxh3_avalanche(h_lo), _xxh3_avalanche(h_hi)
    if n <= 128:
        lo, hi = (n * _P64_1) & _U64, 0
        if n > 32:
            if n > 64:
                if n > 96:
                    lo, hi = _mix32(lo, hi, data, 48, n - 64, 96)
                lo, hi = _mix32(lo, hi, data, 32, n - 48, 64)
            lo, hi = _mix32(lo, hi, data, 16, n - 32, 32)
        lo, hi = _mix32(lo, hi, data, 0, n - 16, 0)
        return _xxh3_128_finish(lo, hi, n)
    if n <= 240:
        lo, hi = (n * _P64_1) & _U64, 0
        for i in range(32, 160, 32):
            lo, hi = _mix32(lo, hi, data, i - 32, i - 16, i - 32)
        lo, hi = _xxh3_avalanche(lo), _xxh3_avalanche(hi)
        for i in range(160, n + 1, 32):
            lo, hi = _mix32(lo, hi, data, i - 32, i - 16, 3 + i - 160)
        # the last 32 bytes, with the halves swapped and the seed negated
        lo, hi = _mix32(lo, hi, data, n - 16, n - 32, 136 - 17 - 16)
        return _xxh3_128_finish(lo, hi, n)
    return _xxh3_128_long(data)


def _xxh3_128_long(data: bytes):
    """Inputs over 240 bytes: 8 accumulators over 64-byte stripes, 16
    stripes a block, scrambled after each block."""
    n, k = len(data), _XXH3_SECRET
    acc = [_P32_3, _P64_1, _P64_2, _P64_3, _P64_4, _P32_2, _P64_5, _P32_1]

    def stripe(i: int, ks: int):
        for j in range(8):
            v = _r64(data, i + 8 * j)
            key = v ^ _r64(k, ks + 8 * j)
            acc[j ^ 1] = (acc[j ^ 1] + v) & _U64
            acc[j] = (acc[j] + (key & 0xFFFFFFFF) * (key >> 32)) & _U64

    per_block = (len(k) - 64) // 8
    block = 64 * per_block
    blocks = (n - 1) // block
    for b in range(blocks):
        for s in range(per_block):
            stripe(b * block + 64 * s, 8 * s)
        for j in range(8):
            a = acc[j] ^ (acc[j] >> 47) ^ _r64(k, len(k) - 64 + 8 * j)
            acc[j] = (a * _P32_1) & _U64
    for s in range(((n - 1) - block * blocks) // 64):
        stripe(blocks * block + 64 * s, 8 * s)
    stripe(n - 64, len(k) - 64 - 7)

    def merge(ks: int, start: int) -> int:
        r = start
        for j in range(4):
            r += _mul128_fold64(acc[2 * j] ^ _r64(k, ks + 16 * j),
                                acc[2 * j + 1] ^ _r64(k, ks + 16 * j + 8))
        return _xxh3_avalanche(r & _U64)

    return (merge(11, (n * _P64_1) & _U64),
            merge(len(k) - 64 - 11, ~(n * _P64_2) & _U64))


# ---- SpookyHash V2 (Bob Jenkins), reimplemented from the published
# algorithm; expectations in tests come from the reference's
# BinaryFunctionsTest.cpp (Presto Java values).

_SC_CONST = 0xDEADBEEFDEADBEEF
_M64 = 0xFFFFFFFFFFFFFFFF


def _rot64(x: int, k: int) -> int:
    return ((x << k) | (x >> (64 - k))) & _M64


def _spooky_short_mix(a, b, c, d):
    for (reg, rot) in ((2, 50), (3, 52), (0, 30), (1, 41),
                       (2, 54), (3, 48), (0, 38), (1, 37),
                       (2, 62), (3, 34), (0, 5), (1, 36)):
        s = [a, b, c, d]
        s[reg] = _rot64(s[reg], rot)
        s[reg] = (s[reg] + s[(reg + 1) % 4]) & _M64
        s[(reg + 2) % 4] ^= s[reg]
        a, b, c, d = s
    return a, b, c, d


def _spooky_short_end(a, b, c, d):
    for (reg, rot) in ((3, 15), (0, 52), (1, 26), (2, 51),
                       (3, 28), (0, 9), (1, 47), (2, 54),
                       (3, 32), (0, 25), (1, 63)):
        s = [a, b, c, d]
        s[reg] ^= s[(reg + 3) % 4]
        s[(reg + 3) % 4] = _rot64(s[(reg + 3) % 4], rot)
        s[reg] = (s[reg] + s[(reg + 3) % 4]) & _M64
        a, b, c, d = s
    return a, b, c, d


def _spooky_short(msg: bytes, h1: int, h2: int):
    import struct

    length = len(msg)
    remainder = length % 32
    a, b = h1, h2
    c = d = _SC_CONST
    p = 0
    if length > 15:
        end = (length // 32) * 32
        while p < end:
            x0, x1, x2, x3 = struct.unpack_from("<4Q", msg, p)
            c = (c + x0) & _M64
            d = (d + x1) & _M64
            a, b, c, d = _spooky_short_mix(a, b, c, d)
            a = (a + x2) & _M64
            b = (b + x3) & _M64
            p += 32
        if remainder >= 16:
            x0, x1 = struct.unpack_from("<2Q", msg, p)
            c = (c + x0) & _M64
            d = (d + x1) & _M64
            a, b, c, d = _spooky_short_mix(a, b, c, d)
            p += 16
            remainder -= 16
    d = (d + (length << 56)) & _M64
    tail = msg[p:]
    cc = dd = 0
    for i in range(min(remainder, 8)):
        cc |= tail[i] << (8 * i)
    for i in range(8, remainder):
        dd |= tail[i] << (8 * (i - 8))
    if remainder == 0:
        c = (c + _SC_CONST) & _M64
        d = (d + _SC_CONST) & _M64
    else:
        c = (c + cc) & _M64
        d = (d + dd) & _M64
    a, b, c, d = _spooky_short_end(a, b, c, d)
    return a, b


def _spooky_mix(x, s):
    for i in range(12):
        s[i] = (s[i] + x[i]) & _M64
        s[(i + 2) % 12] ^= s[(i + 10) % 12]
        s[(i + 11) % 12] ^= s[i]
        s[i] = _rot64(s[i], (11, 32, 43, 31, 17, 28, 39, 57,
                             55, 54, 22, 46)[i])
        s[(i + 11) % 12] = (s[(i + 11) % 12] + s[(i + 1) % 12]) & _M64


def _spooky_end_partial(h):
    rots = (44, 15, 34, 21, 38, 33, 10, 13, 38, 53, 42, 54)
    for i in range(12):
        h[(i + 11) % 12] = (h[(i + 11) % 12] + h[(i + 1) % 12]) & _M64
        h[(i + 2) % 12] ^= h[(i + 11) % 12]
        h[(i + 1) % 12] = _rot64(h[(i + 1) % 12], rots[i])


def _spooky_hash128(msg: bytes, h1: int, h2: int):
    import struct

    if len(msg) < 192:
        return _spooky_short(msg, h1, h2)
    h = [h1, h2, _SC_CONST] * 4
    p = 0
    end = (len(msg) // 96) * 96
    while p < end:
        _spooky_mix(struct.unpack_from("<12Q", msg, p), h)
        p += 96
    remainder = len(msg) - end
    tail = bytearray(96)
    tail[:remainder] = msg[end:]
    tail[95] = remainder
    _spooky_end_partial_data = struct.unpack("<12Q", bytes(tail))
    for i in range(12):
        h[i] = (h[i] + _spooky_end_partial_data[i]) & _M64
    _spooky_end_partial(h)
    _spooky_end_partial(h)
    _spooky_end_partial(h)
    return h[0], h[1]


def spooky_hash_v2_32(s: str) -> str:
    h1, _ = _spooky_hash128(s.encode(), 0, 0)
    return (h1 & 0xFFFFFFFF).to_bytes(4, "big").hex().upper()


def spooky_hash_v2_64(s: str) -> str:
    h1, _ = _spooky_hash128(s.encode(), 0, 0)
    return h1.to_bytes(8, "big").hex().upper()
