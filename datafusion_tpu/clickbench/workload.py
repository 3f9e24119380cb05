"""hits-like data generator + ClickBench query subset."""
from __future__ import annotations

from typing import Dict

import numpy as np


def generate_hits(n: int = 100_000, seed: int = 0) -> Dict[str, np.ndarray]:
    """Synthetic `hits` with the REAL dataset's cardinality RATIOS:
    the public 100M-row hits.parquet carries ~18M distinct URLs, ~4M
    titles, ~120k search phrases and ~17.6M users — dictionary sizes are
    the workload's defining stressor, so they scale with n here instead
    of staying fixed. Zipf skew preserved."""
    rng = np.random.default_rng(seed)
    n_users = max(n // 6, 10)
    # zipf-ish skew for user activity and search phrases (the workload's
    # defining property: heavy hitters in high-cardinality group-bys)
    user = (rng.zipf(1.3, n) % n_users).astype(np.int64)
    n_phrases = max(n // 800, 997)
    phrases = np.concatenate([
        np.array([""], dtype=object),
        np.char.add("search phrase ",
                    np.arange(n_phrases).astype(str)).astype(object)])
    phrase_idx = np.where(rng.random(n) < 0.6, 0,
                          rng.zipf(1.5, n) % len(phrases))
    n_urls = max(n // 6, 5000)
    u_plain = (n_urls * 7) // 10
    u_google = (n_urls * 2) // 10
    u_mail = n_urls - u_plain - u_google
    urls = np.concatenate([
        np.char.add("http://example.com/page",
                    np.arange(u_plain).astype(str)),
        np.char.add("https://www.google.com/search?q=term",
                    np.arange(u_google).astype(str)),
        np.char.add("http://mail.google.com/inbox/",
                    np.arange(u_mail).astype(str)),
    ]).astype(object)
    n_titles = max(n // 25, 3000)
    t_plain = (n_titles * 4) // 5
    titles = np.concatenate([
        np.char.add("Title ", np.arange(t_plain).astype(str)),
        np.char.add("Google Results ",
                    np.arange(n_titles - t_plain).astype(str)),
    ]).astype(object)
    t0 = 1372636800  # 2013-07-01, the canonical hits window
    # string columns ship PRE-DICT-CODED as ("dict", values, codes):
    # at 50M+ rows materializing row-level strings (and re-unique-ing
    # them at registration) would dominate generation
    n_ref = max(n // 12, 4000)
    ref_vals = np.concatenate([
        np.array([""], dtype=object),
        np.char.add(np.char.add("https://www.ref",
                                (np.arange(n_ref) % 97).astype(str)),
                    np.char.add(".com/path",
                                np.arange(n_ref).astype(str))).astype(object),
    ])
    ref_idx = np.where(rng.random(n) < 0.3, 0,
                       1 + rng.integers(0, n_ref, n)).astype(np.int32)
    phone_vals = np.concatenate([
        np.array([""], dtype=object),
        np.array([f"Phone{i}" for i in range(50)], dtype=object)])
    phone_idx = np.where(rng.random(n) < 0.8, 0,
                         1 + rng.integers(0, 50, n)).astype(np.int32)
    return {
        "WatchID": rng.integers(0, 2**62, n),
        # 62 is the counter the range queries (q37-43) filter on; make it a
        # heavy hitter like in the real dataset
        "CounterID": np.where(rng.random(n) < 0.2, 62,
                              rng.integers(0, 6000, n)).astype(np.int64),
        "UserID": user,
        "RegionID": rng.integers(0, 5000, n).astype(np.int64),
        "AdvEngineID": np.where(rng.random(n) < 0.95, 0,
                                rng.integers(1, 20, n)).astype(np.int64),
        "SearchEngineID": rng.integers(0, 5, n).astype(np.int64),
        "SearchPhrase": ("dict", phrases, phrase_idx.astype(np.int32)),
        "URL": ("dict", urls,
                (rng.zipf(1.4, n) % len(urls)).astype(np.int32)),
        "Title": ("dict", titles,
                  rng.integers(0, len(titles), n).astype(np.int32)),
        "EventTime": (t0 + rng.integers(0, 31 * 86400, n)).astype(np.int64),
        # real hits.parquet stores EventDate as UInt16 days-since-epoch;
        # the canonical queries cast it "EventDate"::INT::DATE
        "EventDate": ((t0 + rng.integers(0, 31 * 86400, n)) // 86400
                      ).astype(np.int64),
        "ResolutionWidth": rng.choice(
            [1024, 1280, 1366, 1440, 1536, 1600, 1920, 2560], n).astype(np.int64),
        "MobilePhoneModel": ("dict", phone_vals, phone_idx),
        "MobilePhone": rng.integers(0, 10, n).astype(np.int64),
        "IsRefresh": (rng.random(n) < 0.05).astype(np.int64),
        "DontCountHits": (rng.random(n) < 0.02).astype(np.int64),
        "Referer": ("dict", ref_vals, ref_idx),
        "ClientIP": rng.integers(0, 2**31, n),
        "Duration": rng.integers(0, 5000, n).astype(np.int64),
        # columns the full 43-query set touches (real hits.parquet types:
        # EventDate is UInt16 days-since-epoch, hashes are Int64)
        "IsLink": (rng.random(n) < 0.1).astype(np.int64),
        "IsDownload": (rng.random(n) < 0.02).astype(np.int64),
        "TraficSourceID": rng.choice(
            np.array([-1, 0, 1, 2, 3, 6], dtype=np.int64), n),
        "URLHash": rng.choice(
            np.array([2868770270353813622, 123, 456, 789, 1011],
                     dtype=np.int64), n),
        "RefererHash": rng.choice(
            np.array([3594120000172545465, 1, 2, 3], dtype=np.int64), n),
        "WindowClientWidth": rng.choice(
            [0, 1024, 1280, 1366, 1920], n).astype(np.int64),
        "WindowClientHeight": rng.choice(
            [0, 768, 800, 900, 1080], n).astype(np.int64),
    }


def decode_hits(data: Dict[str, object]) -> Dict[str, np.ndarray]:
    """Materialize the ("dict", values, codes) columns into row-level
    object arrays (test oracles / pandas interop)."""
    out = {}
    for name, v in data.items():
        if isinstance(v, tuple) and v[0] == "dict":
            _tag, values, codes = v
            out[name] = values[codes]
        else:
            out[name] = v
    return out


def register_hits(ctx, n: int = 100_000, seed: int = 0) -> None:
    from ..common import dt
    from ..common.batch import Batch
    from ..common.column import Column, Dictionary
    from ..common.schema import Field, Schema
    from ..datasource.memory import MemTable

    cols = []
    fields = []
    for name, v in generate_hits(n, seed).items():
        if isinstance(v, tuple) and v[0] == "dict":
            _tag, values, codes = v
            # sort the dictionary (engine invariant: min/max and ORDER BY
            # over codes rely on lexicographic code order)
            order = np.argsort(values.astype(str), kind="stable")
            rank = np.empty(len(order), np.int32)
            rank[order] = np.arange(len(order), dtype=np.int32)
            cols.append(Column(dt.STRING, rank[codes], None,
                               Dictionary(values[order])))
            fields.append(Field(name, dt.STRING, False))
        else:
            if v.dtype == object:
                uniq, inv = np.unique(v.astype(str), return_inverse=True)
                c = Column(dt.STRING, inv.astype(np.int32), None,
                           Dictionary(uniq.astype(object)))
                fields.append(Field(name, dt.STRING, False))
            else:
                t = dt.INT64 if v.dtype == np.int64 else \
                    dt.INT32 if v.dtype == np.int32 else dt.FLOAT64
                c = Column(t, v, None)
                fields.append(Field(name, t, False))
            cols.append(c)
    batch = Batch(Schema(fields), cols, n)
    ctx.register_table("hits", MemTable(batch.schema, [[batch]]))


# The public ClickBench statements covering the generated columns
# (numbering follows benchmarks/queries/clickbench/queries.sql).
QUERIES = {
    1: "SELECT COUNT(*) FROM hits",
    2: "SELECT COUNT(*) FROM hits WHERE \"AdvEngineID\" <> 0",
    3: "SELECT SUM(\"AdvEngineID\"), COUNT(*), AVG(\"ResolutionWidth\") FROM hits",
    4: "SELECT AVG(\"UserID\") FROM hits",
    5: "SELECT COUNT(DISTINCT \"UserID\") FROM hits",
    6: "SELECT COUNT(DISTINCT \"SearchPhrase\") FROM hits",
    7: "SELECT MIN(\"EventDate\"::INT::DATE), MAX(\"EventDate\"::INT::DATE) FROM hits",
    8: "SELECT \"AdvEngineID\", COUNT(*) FROM hits WHERE \"AdvEngineID\" <> 0 GROUP BY \"AdvEngineID\" ORDER BY COUNT(*) DESC",
    9: "SELECT \"RegionID\", COUNT(DISTINCT \"UserID\") AS u FROM hits GROUP BY \"RegionID\" ORDER BY u DESC LIMIT 10",
    10: "SELECT \"RegionID\", SUM(\"AdvEngineID\"), COUNT(*) AS c, AVG(\"ResolutionWidth\"), COUNT(DISTINCT \"UserID\") FROM hits GROUP BY \"RegionID\" ORDER BY c DESC LIMIT 10",
    11: "SELECT \"MobilePhoneModel\", COUNT(DISTINCT \"UserID\") AS u FROM hits WHERE \"MobilePhoneModel\" <> '' GROUP BY \"MobilePhoneModel\" ORDER BY u DESC LIMIT 10",
    12: "SELECT \"MobilePhone\", \"MobilePhoneModel\", COUNT(DISTINCT \"UserID\") AS u FROM hits WHERE \"MobilePhoneModel\" <> '' GROUP BY \"MobilePhone\", \"MobilePhoneModel\" ORDER BY u DESC LIMIT 10",
    13: "SELECT \"SearchPhrase\", COUNT(*) AS c FROM hits WHERE \"SearchPhrase\" <> '' GROUP BY \"SearchPhrase\" ORDER BY c DESC LIMIT 10",
    14: "SELECT \"SearchPhrase\", COUNT(DISTINCT \"UserID\") AS u FROM hits WHERE \"SearchPhrase\" <> '' GROUP BY \"SearchPhrase\" ORDER BY u DESC LIMIT 10",
    15: "SELECT \"SearchEngineID\", \"SearchPhrase\", COUNT(*) AS c FROM hits WHERE \"SearchPhrase\" <> '' GROUP BY \"SearchEngineID\", \"SearchPhrase\" ORDER BY c DESC LIMIT 10",
    16: "SELECT \"UserID\", COUNT(*) FROM hits GROUP BY \"UserID\" ORDER BY COUNT(*) DESC LIMIT 10",
    17: "SELECT \"UserID\", \"SearchPhrase\", COUNT(*) FROM hits GROUP BY \"UserID\", \"SearchPhrase\" ORDER BY COUNT(*) DESC LIMIT 10",
    18: "SELECT \"UserID\", \"SearchPhrase\", COUNT(*) FROM hits GROUP BY \"UserID\", \"SearchPhrase\" LIMIT 10",
    19: "SELECT \"UserID\", extract(minute FROM to_timestamp_seconds(\"EventTime\")) AS m, \"SearchPhrase\", COUNT(*) FROM hits GROUP BY \"UserID\", m, \"SearchPhrase\" ORDER BY COUNT(*) DESC LIMIT 10",
    20: "SELECT \"UserID\" FROM hits WHERE \"UserID\" = 435090932899640449",
    21: "SELECT COUNT(*) FROM hits WHERE \"URL\" LIKE '%google%'",
    22: "SELECT \"SearchPhrase\", MIN(\"URL\"), COUNT(*) AS c FROM hits WHERE \"URL\" LIKE '%google%' AND \"SearchPhrase\" <> '' GROUP BY \"SearchPhrase\" ORDER BY c DESC LIMIT 10",
    23: "SELECT \"SearchPhrase\", MIN(\"URL\"), MIN(\"Title\"), COUNT(*) AS c, COUNT(DISTINCT \"UserID\") FROM hits WHERE \"Title\" LIKE '%Google%' AND \"URL\" NOT LIKE '%.google.%' AND \"SearchPhrase\" <> '' GROUP BY \"SearchPhrase\" ORDER BY c DESC LIMIT 10",
    24: "SELECT * FROM hits WHERE \"URL\" LIKE '%google%' ORDER BY to_timestamp_seconds(\"EventTime\") LIMIT 10",
    25: "SELECT \"SearchPhrase\" FROM hits WHERE \"SearchPhrase\" <> '' ORDER BY to_timestamp_seconds(\"EventTime\") LIMIT 10",
    26: "SELECT \"SearchPhrase\" FROM hits WHERE \"SearchPhrase\" <> '' ORDER BY \"SearchPhrase\" LIMIT 10",
    27: "SELECT \"SearchPhrase\" FROM hits WHERE \"SearchPhrase\" <> '' ORDER BY to_timestamp_seconds(\"EventTime\"), \"SearchPhrase\" LIMIT 10",
    28: "SELECT \"CounterID\", AVG(length(\"URL\")) AS l, COUNT(*) AS c FROM hits WHERE \"URL\" <> '' GROUP BY \"CounterID\" HAVING COUNT(*) > 100000 ORDER BY l DESC LIMIT 25",
    29: "SELECT REGEXP_REPLACE(\"Referer\", '^https?://(?:www\\.)?([^/]+)/.*$', '\\1') AS k, AVG(length(\"Referer\")) AS l, COUNT(*) AS c, MIN(\"Referer\") FROM hits WHERE \"Referer\" <> '' GROUP BY k HAVING COUNT(*) > 100000 ORDER BY l DESC LIMIT 25",
    30: "SELECT SUM(\"ResolutionWidth\"), SUM(\"ResolutionWidth\" + 1), SUM(\"ResolutionWidth\" + 2), SUM(\"ResolutionWidth\" + 3), SUM(\"ResolutionWidth\" + 4), SUM(\"ResolutionWidth\" + 5), SUM(\"ResolutionWidth\" + 6), SUM(\"ResolutionWidth\" + 7), SUM(\"ResolutionWidth\" + 8), SUM(\"ResolutionWidth\" + 9), SUM(\"ResolutionWidth\" + 10), SUM(\"ResolutionWidth\" + 11), SUM(\"ResolutionWidth\" + 12), SUM(\"ResolutionWidth\" + 13), SUM(\"ResolutionWidth\" + 14), SUM(\"ResolutionWidth\" + 15), SUM(\"ResolutionWidth\" + 16), SUM(\"ResolutionWidth\" + 17), SUM(\"ResolutionWidth\" + 18), SUM(\"ResolutionWidth\" + 19), SUM(\"ResolutionWidth\" + 20), SUM(\"ResolutionWidth\" + 21), SUM(\"ResolutionWidth\" + 22), SUM(\"ResolutionWidth\" + 23), SUM(\"ResolutionWidth\" + 24), SUM(\"ResolutionWidth\" + 25), SUM(\"ResolutionWidth\" + 26), SUM(\"ResolutionWidth\" + 27), SUM(\"ResolutionWidth\" + 28), SUM(\"ResolutionWidth\" + 29), SUM(\"ResolutionWidth\" + 30), SUM(\"ResolutionWidth\" + 31), SUM(\"ResolutionWidth\" + 32), SUM(\"ResolutionWidth\" + 33), SUM(\"ResolutionWidth\" + 34), SUM(\"ResolutionWidth\" + 35), SUM(\"ResolutionWidth\" + 36), SUM(\"ResolutionWidth\" + 37), SUM(\"ResolutionWidth\" + 38), SUM(\"ResolutionWidth\" + 39), SUM(\"ResolutionWidth\" + 40), SUM(\"ResolutionWidth\" + 41), SUM(\"ResolutionWidth\" + 42), SUM(\"ResolutionWidth\" + 43), SUM(\"ResolutionWidth\" + 44), SUM(\"ResolutionWidth\" + 45), SUM(\"ResolutionWidth\" + 46), SUM(\"ResolutionWidth\" + 47), SUM(\"ResolutionWidth\" + 48), SUM(\"ResolutionWidth\" + 49), SUM(\"ResolutionWidth\" + 50), SUM(\"ResolutionWidth\" + 51), SUM(\"ResolutionWidth\" + 52), SUM(\"ResolutionWidth\" + 53), SUM(\"ResolutionWidth\" + 54), SUM(\"ResolutionWidth\" + 55), SUM(\"ResolutionWidth\" + 56), SUM(\"ResolutionWidth\" + 57), SUM(\"ResolutionWidth\" + 58), SUM(\"ResolutionWidth\" + 59), SUM(\"ResolutionWidth\" + 60), SUM(\"ResolutionWidth\" + 61), SUM(\"ResolutionWidth\" + 62), SUM(\"ResolutionWidth\" + 63), SUM(\"ResolutionWidth\" + 64), SUM(\"ResolutionWidth\" + 65), SUM(\"ResolutionWidth\" + 66), SUM(\"ResolutionWidth\" + 67), SUM(\"ResolutionWidth\" + 68), SUM(\"ResolutionWidth\" + 69), SUM(\"ResolutionWidth\" + 70), SUM(\"ResolutionWidth\" + 71), SUM(\"ResolutionWidth\" + 72), SUM(\"ResolutionWidth\" + 73), SUM(\"ResolutionWidth\" + 74), SUM(\"ResolutionWidth\" + 75), SUM(\"ResolutionWidth\" + 76), SUM(\"ResolutionWidth\" + 77), SUM(\"ResolutionWidth\" + 78), SUM(\"ResolutionWidth\" + 79), SUM(\"ResolutionWidth\" + 80), SUM(\"ResolutionWidth\" + 81), SUM(\"ResolutionWidth\" + 82), SUM(\"ResolutionWidth\" + 83), SUM(\"ResolutionWidth\" + 84), SUM(\"ResolutionWidth\" + 85), SUM(\"ResolutionWidth\" + 86), SUM(\"ResolutionWidth\" + 87), SUM(\"ResolutionWidth\" + 88), SUM(\"ResolutionWidth\" + 89) FROM hits",
    31: "SELECT \"SearchEngineID\", \"ClientIP\", COUNT(*) AS c, SUM(\"IsRefresh\"), AVG(\"ResolutionWidth\") FROM hits WHERE \"SearchPhrase\" <> '' GROUP BY \"SearchEngineID\", \"ClientIP\" ORDER BY c DESC LIMIT 10",
    32: "SELECT \"WatchID\", \"ClientIP\", COUNT(*) AS c, SUM(\"IsRefresh\"), AVG(\"ResolutionWidth\") FROM hits WHERE \"SearchPhrase\" <> '' GROUP BY \"WatchID\", \"ClientIP\" ORDER BY c DESC LIMIT 10",
    33: "SELECT \"WatchID\", \"ClientIP\", COUNT(*) AS c, SUM(\"IsRefresh\"), AVG(\"ResolutionWidth\") FROM hits GROUP BY \"WatchID\", \"ClientIP\" ORDER BY c DESC LIMIT 10",
    34: "SELECT \"URL\", COUNT(*) AS c FROM hits GROUP BY \"URL\" ORDER BY c DESC LIMIT 10",
    35: "SELECT 1, \"URL\", COUNT(*) AS c FROM hits GROUP BY 1, \"URL\" ORDER BY c DESC LIMIT 10",
    36: "SELECT \"ClientIP\", \"ClientIP\" - 1, \"ClientIP\" - 2, \"ClientIP\" - 3, COUNT(*) AS c FROM hits GROUP BY \"ClientIP\", \"ClientIP\" - 1, \"ClientIP\" - 2, \"ClientIP\" - 3 ORDER BY c DESC LIMIT 10",
    37: "SELECT \"URL\", COUNT(*) AS PageViews FROM hits WHERE \"CounterID\" = 62 AND \"EventDate\"::INT::DATE >= '2013-07-01' AND \"EventDate\"::INT::DATE <= '2013-07-31' AND \"DontCountHits\" = 0 AND \"IsRefresh\" = 0 AND \"URL\" <> '' GROUP BY \"URL\" ORDER BY PageViews DESC LIMIT 10",
    38: "SELECT \"Title\", COUNT(*) AS PageViews FROM hits WHERE \"CounterID\" = 62 AND \"EventDate\"::INT::DATE >= '2013-07-01' AND \"EventDate\"::INT::DATE <= '2013-07-31' AND \"DontCountHits\" = 0 AND \"IsRefresh\" = 0 AND \"Title\" <> '' GROUP BY \"Title\" ORDER BY PageViews DESC LIMIT 10",
    39: "SELECT \"URL\", COUNT(*) AS PageViews FROM hits WHERE \"CounterID\" = 62 AND \"EventDate\"::INT::DATE >= '2013-07-01' AND \"EventDate\"::INT::DATE <= '2013-07-31' AND \"IsRefresh\" = 0 AND \"IsLink\" <> 0 AND \"IsDownload\" = 0 GROUP BY \"URL\" ORDER BY PageViews DESC LIMIT 10 OFFSET 1000",
    40: "SELECT \"TraficSourceID\", \"SearchEngineID\", \"AdvEngineID\", CASE WHEN (\"SearchEngineID\" = 0 AND \"AdvEngineID\" = 0) THEN \"Referer\" ELSE '' END AS Src, \"URL\" AS Dst, COUNT(*) AS PageViews FROM hits WHERE \"CounterID\" = 62 AND \"EventDate\"::INT::DATE >= '2013-07-01' AND \"EventDate\"::INT::DATE <= '2013-07-31' AND \"IsRefresh\" = 0 GROUP BY \"TraficSourceID\", \"SearchEngineID\", \"AdvEngineID\", Src, Dst ORDER BY PageViews DESC LIMIT 10 OFFSET 1000",
    41: "SELECT \"URLHash\", \"EventDate\"::INT::DATE, COUNT(*) AS PageViews FROM hits WHERE \"CounterID\" = 62 AND \"EventDate\"::INT::DATE >= '2013-07-01' AND \"EventDate\"::INT::DATE <= '2013-07-31' AND \"IsRefresh\" = 0 AND \"TraficSourceID\" IN (-1, 6) AND \"RefererHash\" = 3594120000172545465 GROUP BY \"URLHash\", \"EventDate\"::INT::DATE ORDER BY PageViews DESC LIMIT 10 OFFSET 100",
    42: "SELECT \"WindowClientWidth\", \"WindowClientHeight\", COUNT(*) AS PageViews FROM hits WHERE \"CounterID\" = 62 AND \"EventDate\"::INT::DATE >= '2013-07-01' AND \"EventDate\"::INT::DATE <= '2013-07-31' AND \"IsRefresh\" = 0 AND \"DontCountHits\" = 0 AND \"URLHash\" = 2868770270353813622 GROUP BY \"WindowClientWidth\", \"WindowClientHeight\" ORDER BY PageViews DESC LIMIT 10 OFFSET 10000",
    43: "SELECT DATE_TRUNC('minute', to_timestamp_seconds(\"EventTime\")) AS M, COUNT(*) AS PageViews FROM hits WHERE \"CounterID\" = 62 AND \"EventDate\"::INT::DATE >= '2013-07-14' AND \"EventDate\"::INT::DATE <= '2013-07-15' AND \"IsRefresh\" = 0 AND \"DontCountHits\" = 0 GROUP BY DATE_TRUNC('minute', to_timestamp_seconds(\"EventTime\")) ORDER BY DATE_TRUNC('minute', M) LIMIT 10 OFFSET 1000",
}
