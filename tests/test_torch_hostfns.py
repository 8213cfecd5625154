"""The port's ``functions/hostfns.py`` against the JAX package's, and the
string-function gap between the two packages.

* Every public function of the reference module (but the two digest
  readers, which wait for ``functions/digest.py``) is called with the
  same arguments through both modules, one case per family: results,
  and the type of a raised error, must be equal (NaN equal to NaN).
* XXH64 and XXH3-128 are plain Python in the port: with the ``xxhash``
  package hidden they must equal it over inputs of every length class of
  XXH3 (0, 1-3, 4-8, 9-16, 17-128, 129-240 and longer, across its
  1024-byte blocks).
* The gap: every name of the reference's string binders binds in the
  port and gives the JAX package's result, except the ten names that
  read digests and sketches; the families above call every function of
  the reference module but the digest readers.
"""

import math
import sys

import pytest

import velox_tpu.functions.hostfns as ref
import velox_tpu_torch.functions.hostfns as port
from torch_string_exprs import DEFERRED, FAMILIES, PORT_ONLY, string_table
from torch_tpch_data import assert_same, table_in_both

#: string inputs of the families
INPUTS = [
    "", "a", "apple pie", " Kiwi ", "ß é 𝄞", "12", "-3.5", "0x1F",
    "2024-03-01", "2024-03-01T13:45:10Z", "2024-03-01 13:45:10.5",
    '{"a": [1, 2, {"b": "x"}], "c": null, "d": 1.5}', "[1, 2, 3]", "null",
    "http://user@x.org:8080/p/q?x=1&y=2&y=3#frag", "ftp://h/a%20b",
    "10.1.2.3", "192.168.0.0/16", "::1", "2001:db8::/32", "SGVsbG8=",
    "SGVsbG8", "JBSWY3DP", "4111111111111111", "1.5GB", "512 kB",
    "3h 2m", "1.5d", "Robert", "Tymczak", "abcdefghijklmnopqrstuvwxyz012345",
    "x" * 200, "\t tabs\n", "a+b%20c%", "running", "flies",
]
DAYS = [-719162, -1, 0, 59, 10471, 19783, 2932896]
MICROS = [0, -1, 1_709_300_710_123_456, -62_135_596_800_000_000]
INTS = [0, 1, -1, 255, 2 ** 31 - 1, -2 ** 31, 2 ** 40]


def _over(*extra):
    return [(s, *extra) for s in INPUTS]


#: family -> {function name: argument tuples}
CASES = {
    "regex": {
        "regexp_like": _over("^\\p{Alpha}+$") + _over("[[:digit:]]+")
        + _over("\\h") + _over("\\Qa+b\\E") + _over("(?i)KIWI"),
        "regexp_extract": _over("[a-z]+") + _over("(\\d+)-(\\d+)", 2)
        + _over("(\\d+)", 3),
        "regexp_replace": _over("([aeiou])", "<$1>") + _over("\\s+"),
        "regexp_count": _over("\\p{Lower}"),
        "regexp_position": _over("p"),
    },
    "datetime": {
        "date_format_days": [(d, f) for d in DAYS for f in (
            "%Y-%m-%d", "%a %b %e %j %W", "%y%c%D %U")],
        "format_datetime_days": [(d, f) for d in DAYS for f in (
            "yyyy-MM-dd", "EEE MMM d", "YYYY ww D")],
        "date_format_micros": [(u, "%Y-%m-%d %H:%i:%s.%f") for u in MICROS],
        "format_datetime_micros": [(u, "yyyy-MM-dd HH:mm:ss.SSS")
                                   for u in MICROS],
        "parse_datetime_micros": _over("yyyy-MM-dd")
        + _over("yyyy-MM-dd HH:mm:ss.S"),
        "from_iso8601_date_days": _over(),
        "from_iso8601_timestamp_micros": _over(),
        "date_parse_micros": _over("%Y-%m-%d") + _over("%Y-%m-%d %H:%i:%s"),
        "parse_duration_ms": _over(),
    },
    "json": {
        "json_extract_scalar": _over("$.a[0]") + _over("$.d") + _over("$"),
        "json_extract": _over("$.a") + _over("$.a[2].b"),
        "json_array_length": _over(), "json_size": _over("$.a"),
        "is_json_scalar": _over(), "json_parse": _over(),
        "json_format": _over(), "json_array_contains": _over(2)
        + _over("x"), "json_array_get": _over(0) + _over(-1),
    },
    "url": {
        "url_extract_host": _over(), "url_extract_protocol": _over(),
        "url_extract_path": _over(), "url_extract_query": _over(),
        "url_extract_fragment": _over(), "url_extract_port": _over(),
        "url_extract_parameter": _over("y") + _over("x"),
        "url_encode": _over(), "url_decode": _over(),
    },
    "hashes_codecs": {
        **{n: _over() for n in (
            "md5_hex", "sha1_hex", "sha256_hex", "sha512_hex", "crc32_int",
            "xxhash64_hex", "xxhash128_hex", "murmur3_x64_128_hex",
            "spooky_hash_v2_32", "spooky_hash_v2_64", "fnv1_32", "fnv1_64",
            "fnv1a_32", "fnv1a_64", "key_sampling_percent", "to_hex_str",
            "to_hex", "from_hex", "to_base64", "from_base64",
            "to_base64url", "from_base64url", "to_base32", "from_base32",
            "to_utf8", "from_utf8", "from_big_endian_32",
            "from_big_endian_64", "from_ieee754_32", "from_ieee754_64")},
        **{n: _over("key") for n in (
            "hmac_md5", "hmac_sha1", "hmac_sha256", "hmac_sha512")},
        "from_base": _over(16) + _over(36) + _over(2),
        "to_big_endian_32": [(v,) for v in INTS[:-1]],
        "to_big_endian_64": [(v,) for v in INTS],
    },
    "ip": {
        "ip_prefix": _over(24) + _over(64), "ip_subnet_min": _over(),
        "ip_subnet_max": _over(), "is_private_ip": _over(),
        "is_subnet_of": [(p, s) for p in ("10.0.0.0/8", "2001:db8::/32")
                         for s in INPUTS],
    },
    "additions": {
        "levenshtein_distance": _over("apple"),
        "hamming_distance": _over("apple"), "codepoint_int": _over(),
        "normalize_nfc": _over() + _over("NFKD"), "word_stem_en": _over(),
        "octet_length": _over(), "soundex": _over(),
        "translate3": _over("pe", "P"), "trim_chars": _over(" a"),
        "ltrim_chars": _over(" a"), "rtrim_chars": _over(" e"),
        "luhn_check": _over(), "bit_length_int": _over(),
        "strrpos": _over("p") + _over("p", 2),
        "replace_first3": _over("p", "Q"),
        "longest_common_prefix2": _over("app"),
        "jarowinkler_similarity2": _over("apple"),
        "trail_n": _over(2) + _over(0),
        "parse_presto_data_size_int": _over(),
    },
}


def _outcome(fn, args):
    try:
        return fn(*args)
    except Exception as e:     # the error's type is the result
        return type(e)


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    return a == b


@pytest.mark.parametrize("family", list(CASES))
def test_hostfns_family_matches_jax(family):
    for name, calls in CASES[family].items():
        for args in calls:
            want = _outcome(getattr(ref, name), args)
            got = _outcome(getattr(port, name), args)
            assert _same(got, want), (name, args, got, want)


#: inputs of every XXH3 length class, and across 1024-byte blocks
XXH_LENGTHS = [0, 1, 2, 3, 4, 7, 8, 9, 15, 16, 17, 31, 32, 33, 64, 65, 96,
               97, 127, 128, 129, 160, 200, 239, 240, 241, 256, 1023, 1024,
               1025, 2048, 3000]


def test_xxhash_without_the_package(monkeypatch):
    import xxhash

    texts = ["".join(chr(0x20 + (7 * i + n) % 0x5E) for i in range(n))
             for n in XXH_LENGTHS] + ["ß é 𝄞" * 9, "ß" * 120]
    want = [(xxhash.xxh64(t.encode()).hexdigest(),
             xxhash.xxh128(t.encode()).hexdigest().upper(),
             ref.key_sampling_percent(t)) for t in texts]
    monkeypatch.setitem(sys.modules, "xxhash", None)
    got = [(port.xxhash64_hex(t), port.xxhash128_hex(t),
            port.key_sampling_percent(t)) for t in texts]
    for t, g, w in zip(texts, got, want):
        assert g[:2] == w[:2], (len(t.encode()), g, w)
        assert _same(g[2], w[2]), len(t.encode())


def test_every_reference_name_binds_in_the_port_but_ten():
    """The reference's binder tables and the names it binds beside them
    against the port: each name of ``torch_string_exprs`` binds in the
    port with the JAX package's result, the ten deferred ones raise
    ``NotImplementedError``; the port's ``hostfns`` has every function
    of the reference's but the two digest readers."""
    import velox_tpu.expr.compiler as C
    from velox_tpu.exec import run_plan as jax_run_plan
    from velox_tpu.plan import PlanBuilder as JaxPlanBuilder
    from velox_tpu_torch.exec import run_plan as torch_run_plan
    from velox_tpu_torch.plan import PlanBuilder as TorchPlanBuilder

    reference = (set(C._STRING_HOST_FNS) | set(C._STRING_MULTI_FNS)
                 | set(C._DICT_VALUE_FNS) | set(C._INT_VALUE_FNS)
                 | set(C._PAIR_HOST_FNS)
                 | {"length", "concat", "substr", "date_format",
                    "format_datetime"})
    exprs = {n: e for fam in FAMILIES.values() for n, e in fam.items()}
    assert len(DEFERRED) == 10
    assert reference == set(exprs) | set(DEFERRED) | set(PORT_ONLY)

    cols, dicts = string_table()
    with table_in_both("gap", cols, dicts, batch_rows=16):
        def project(pb, e):
            return pb().table_scan("gap").project([f"{e} AS r"]).build()

        for name, e in {**exprs, **PORT_ONLY}.items():
            got = torch_run_plan(project(TorchPlanBuilder, e))
            if name in PORT_ONLY:
                e = e.replace(name, "strpos")
            assert_same(got, jax_run_plan(project(JaxPlanBuilder, e))
                        .to_pydict(), name)
        for name, e in DEFERRED.items():
            with pytest.raises(NotImplementedError, match=name):
                torch_run_plan(project(TorchPlanBuilder, e))

    public = {n for n in dir(ref) if not n.startswith("_")
              and callable(getattr(ref, n))
              and getattr(getattr(ref, n), "__module__", "") == ref.__name__}
    digests = {"digest_value_at_quantile", "digest_quantile_at_value"}
    assert public - {n for n in dir(port) if not n.startswith("_")} == \
        digests
    assert set().union(*CASES.values()) == public - digests
