"""The string functions of the port's tests, by family: one call of each
name the JAX package binds over a dictionary column, over the columns of
``string_table()``: ``s`` a VARCHAR with NULL, ``''``, blanks, ``é``,
``ß``, a 4-byte code point and values each family parses; ``d`` a DATE
and ``i`` a BIGINT, both with stats."""

import numpy as np

#: the values of ``s`` (None is NULL)
S_VALUES = [
    None, "", "apple", " Kiwi ", "ß é 𝄞", "  spaced out  ", "12",
    "-3.5", "2024-03-01", "2024-03-01T13:45:10Z", "1999-12-31 23:59:59",
    '{"a": [1, 2, {"b": "x"}], "c": null}', "[1, 2, 3]", "true",
    "http://user@x.org:8080/p/q?x=1&y=2#frag", "10.1.2.3",
    "192.168.0.0/16", "SGVsbG8=", "JBSWY3DP", "4111111111111111",
    "1.5GB", "3h", "Robert", "ABCD", "a+b%20c",
]

#: family -> {name: expression}; each name is the one the reference's
#: binder tables use (the trims with a character set are ``trim2``,
#: ``ltrim2``, ``rtrim2``)
FAMILIES = {
    "one_argument": {
        "upper": "upper(s)", "lower": "lower(s)", "trim": "trim(s)",
        "ltrim": "ltrim(s)", "rtrim": "rtrim(s)", "reverse": "reverse(s)",
        "length": "length(s)", "concat": "concat('<', s, '|', '>')",
        "substr": "substr(s, 2, 3)", "octet_length": "octet_length(s)",
        "bit_length": "bit_length(s)",
    },
    "multi_argument": {
        "replace": "replace(s, 'p', 'PP')", "trim2": "trim(s, ' e')",
        "ltrim2": "ltrim(s, ' aK')", "rtrim2": "rtrim(s, ' e')",
        "lpad": "lpad(s, 6, '*-')", "rpad": "rpad(s, 6, '*-')",
        "split_part": "split_part(s, ' ', 2)", "strpos": "strpos(s, 'p')",
        "starts_with": "starts_with(s, 'ap')",
        "ends_with": "ends_with(s, '2')",
    },
    "regex": {
        "regexp_like": "regexp_like(s, '^\\p{Alpha}+$')",
        "regexp_extract": "regexp_extract(s, '[a-z]+')",
        "regexp_replace": "regexp_replace(s, '([aeiou])', '<$1>')",
        "regexp_count": "regexp_count(s, '[[:digit:]]')",
        "regexp_position": "regexp_position(s, 'p')",
    },
    "json_url": {
        "json_extract_scalar": "json_extract_scalar(s, '$.a[0]')",
        "json_extract": "json_extract(s, '$.a')",
        "json_array_length": "json_array_length(s)",
        "json_size": "json_size(s, '$.a')",
        "is_json_scalar": "is_json_scalar(s)",
        "json_parse": "json_parse(s)", "json_format": "json_format(s)",
        "json_array_contains": "json_array_contains(s, 2)",
        "json_array_get": "json_array_get(s, 0)",
        "url_extract_host": "url_extract_host(s)",
        "url_extract_protocol": "url_extract_protocol(s)",
        "url_extract_path": "url_extract_path(s)",
        "url_extract_query": "url_extract_query(s)",
        "url_extract_fragment": "url_extract_fragment(s)",
        "url_extract_port": "url_extract_port(s)",
        "url_extract_parameter": "url_extract_parameter(s, 'y')",
        "url_encode": "url_encode(s)", "url_decode": "url_decode(s)",
    },
    "hashes": {
        "md5": "md5(s)", "sha1": "sha1(s)", "sha256": "sha256(s)",
        "sha512": "sha512(s)", "crc32": "crc32(s)",
        "xxhash64": "xxhash64(s)", "xxhash128": "xxhash128(s)",
        "murmur3_x64_128": "murmur3_x64_128(s)",
        "spooky_hash_v2_32": "spooky_hash_v2_32(s)",
        "spooky_hash_v2_64": "spooky_hash_v2_64(s)",
        "fnv1_32": "fnv1_32(s)", "fnv1_64": "fnv1_64(s)",
        "fnv1a_32": "fnv1a_32(s)", "fnv1a_64": "fnv1a_64(s)",
        "hmac_md5": "hmac_md5(s, 'k')", "hmac_sha1": "hmac_sha1(s, 'k')",
        "hmac_sha256": "hmac_sha256(s, 'k')",
        "hmac_sha512": "hmac_sha512(s, 'k')",
        "key_sampling_percent": "key_sampling_percent(s)",
    },
    "codecs": {
        "to_hex": "to_hex(s)", "from_hex": "from_hex(s)",
        "to_base64": "to_base64(s)", "from_base64": "from_base64(s)",
        "to_base64url": "to_base64url(s)",
        "from_base64url": "from_base64url(s)",
        "to_base32": "to_base32(s)", "from_base32": "from_base32(s)",
        "to_utf8": "to_utf8(s)", "from_utf8": "from_utf8(s)",
        "from_base": "from_base(s, 16)",
        "from_big_endian_32": "from_big_endian_32(s)",
        "from_big_endian_64": "from_big_endian_64(s)",
        "from_ieee754_32": "from_ieee754_32(s)",
        "from_ieee754_64": "from_ieee754_64(s)",
    },
    "additions": {
        "levenshtein_distance": "levenshtein_distance(s, 'apple')",
        "hamming_distance": "hamming_distance(s, 'apple')",
        "codepoint": "codepoint(substr(s, 1, 1))",
        "normalize": "normalize(s)", "word_stem": "word_stem(s)",
        "soundex": "soundex(s)", "translate": "translate(s, 'pe', 'P')",
        "luhn_check": "luhn_check(s)", "strrpos": "strrpos(s, 'p')",
        "replace_first": "replace_first(s, 'p', 'Q')",
        "longest_common_prefix": "longest_common_prefix(s, 'app')",
        "jarowinkler_similarity": "jarowinkler_similarity(s, 'apple')",
        "trail": "trail(s, 2)",
        "parse_presto_data_size": "parse_presto_data_size(s)",
    },
    "parse": {
        "parse_datetime": "parse_datetime(s, 'yyyy-MM-dd')",
        "from_iso8601_date": "from_iso8601_date(s)",
        "from_iso8601_timestamp": "from_iso8601_timestamp(s)",
        "date_parse": "date_parse(s, '%Y-%m-%d %H:%i:%s')",
        "parse_duration": "parse_duration(s)",
        "ip_prefix": "ip_prefix(s, 24)", "ip_subnet_min": "ip_subnet_min(s)",
        "ip_subnet_max": "ip_subnet_max(s)",
        "is_private_ip": "is_private_ip(s)",
        "is_subnet_of": "is_subnet_of('10.0.0.0/8', s)",
    },
    "ranges": {
        "date_format": "date_format(d, '%Y-%m %a')",
        "format_datetime": "format_datetime(d, 'yyyy-MM-dd EEE')",
        "day_name": "day_name(d)", "month_name": "month_name(d)",
        "chr": "chr(i)", "to_base": "to_base(i, 7)",
        "to_big_endian_32": "to_big_endian_32(i)",
        "to_big_endian_64": "to_big_endian_64(i)",
        "human_readable_seconds": "human_readable_seconds(i)",
        "to_milliseconds": "to_milliseconds(to_base(i, 10))",
    },
}

#: names the reference binds and the port leaves to the digest and
#: sketch slices
DEFERRED = {
    "value_at_quantile": "value_at_quantile(s, 0.5)",
    "quantile_at_value": "quantile_at_value(s, 1.0)",
    "sketch_cardinality": "sketch_cardinality(s)",
    "scale_tdigest": "scale_tdigest(s, 2.0)",
    "trimmed_mean": "trimmed_mean(s, 0.1, 0.9)",
    "hash_counts": "hash_counts(s)",
    "uniqueness_distribution": "uniqueness_distribution(s)",
    "reidentification_potential": "reidentification_potential(s, 10)",
    "intersection_cardinality": "intersection_cardinality(s, s)",
    "jaccard_index": "jaccard_index(s, s)",
}

#: a name the reference lists but cannot resolve (no result type), which
#: the port binds as ``strpos``
PORT_ONLY = {"position": "position(s, 'p')"}


def string_table():
    """(columns, dictionaries) of the table the expressions read."""
    n = len(S_VALUES)
    values = sorted({v for v in S_VALUES if v is not None})
    s = np.asarray([-1 if v is None else values.index(v) for v in S_VALUES],
                   dtype=np.int32)
    cols = {"k": np.arange(n, dtype=np.int64), "s": s,
            "d": (np.arange(n) * 397 - 4000).astype("datetime64[D]"),
            "i": np.arange(n, dtype=np.int64) * 4 - 5}
    return cols, {"s": values}
