#!/usr/bin/env python3
"""On-card smoke test and measurement of the PyTorch/CUDA port
(``pinot_tpu_torch``): builds the CUDA kernels from this checkout (one
nvcc per source, started together), holds each against its plain torch
version, and drives the port's paths through parse -> optimize ->
QueryExecutor.execute -> reduce_to_response on one card:

  1. TPC-H Q1, the Q3-shaped query and an unsorted RANGE (K1) over
     134,217,728 lineitem rows, against a float64 numpy oracle;
  2. the value-state queries (distinctcount, percentile, HLL; K2) over the
     same rows, against exact host oracles;
  3. a plan outside K1's fused route (OR filter, sum + min), whose group
     sums go through K1 over the evaluated mask: run twice, bit-identical;
  4. the north-star HLL group-by (NORTHSTAR_HLL.json) over 134,217,728
     ad-events rows, against registers built on the host;
  5. selection queries (no sort, a packed ORDER BY key, the lexicographic
     branch with an offset) over the lineitem rows, against rows picked
     on the host;
  6. exact distinct over (group, value) pairs (percentile, distinctcount,
     the exact reach and a per-site HLL past the dense holders), the group
     counts through K1 over the evaluated mask, against host oracles;
  7. the host tier: a group space past the dense holder served by the
     host before anything is staged, and a pair overflow the host finishes
     after the device run (K1, the pair reduce), against host oracles,
     timed apart (medians of 3, with hostMs and segmentsHost);
  8. multi-value columns over 33,554,432 rows of make_test_schema()'s
     table (MV_ANY and MV_NONE leaves, the group-by expansion through K1
     over each row's entries, every MV value state through K2 over the
     flattened entries), against exact and float64 oracles over the CSR
     arrays, with K1 and K2 at those launch shapes against their plain
     versions and their bounds;
  9. serving: the lineitem table split over two port ServerInstances (8
     segments each, each server's launches on its own device lane and
     CUDA stream) behind the port's broker over TCP on localhost: q1, q3,
     hll_groupby, distinct_price, sel_top and pairs_distinct against the
     same oracles, broker p50 / p99 over 20 requests each with the
     servers' queue / lane-wait / finalize split and the DataTable bytes
     per reply; 8 concurrent identical q1s (byte-identical answers, the
     lanes coalesce) and 8 concurrent q1s at distinct literals (each
     against its own oracle); the micro-batching tier: eight-literal
     bursts of q1 (dates), range_unsorted and distinct_price (l_quantity
     thresholds), each answer against its own oracle, at the batching
     defaults (the batched kernels' launches counted) and again with
     config.BATCH_MAX = 1 (broker p50 / p99, the lanes' batchLaunches /
     batchedQueries, the replies' batchHits, the members on the block
     path); then on a reduced table (2 segments of 2^20 rows) a device
     fault injector's transient (one device retry), poisoned plan and
     stalled launch (the host tier answers);
 10. zone maps and the deployed cluster: zone_in (Q1's aggregations over
     three dates of the clustered l_shipdate, K1's fused route) and
     zone_distinct (distinctcount under the same filter, K2's) in
     process over the candidate zone blocks only (the kernels read the
     block table in place), then as full scans (zone_maps=False), each
     against its oracle, with K1 and K2 at both launch shapes against
     their plain versions and bounds; then the lineitem segments written
     as segment files, a controller, two servers and a broker started
     as processes of ``python -m pinot_tpu_torch.tools.admin``, the
     files uploaded through the controller (8 segments a server), and
     q1, q3, hll_groupby, distinct_price, sel_top, pairs_distinct,
     zone_in and zone_distinct sent to the broker's HTTP ``/query``:
     each answer against its oracle, the servers' kernel launches read
     from their ``/debug/metrics``, broker p50 / p99 over 20 requests,
     the servers' own phase medians, and the write, upload, upload to
     ONLINE and segment load times; EXPLAIN through the broker of q1, a
     zone-block q1, zone_in (postings) and bsi_count_sum (``explain_checks``:
     plain EXPLAIN moves no launch, dispatch, staged or allocated byte on
     the servers, its tiers are the executed ones, its device digests the
     ones the lanes record, ANALYZE's actualCost the reply's cost); every
     role stopped with SIGTERM;
 11. joins over the Star Schema Benchmark's lineorder (16 segments of
     2^20 rows = 16,777,216, partitioned on lo_partkey), part (400,000
     rows, partitioned on p_partkey) and date (2,556 rows): ssb_q1_1
     (scalar, broadcast), ssb_q2_1 (a build-side group, colocated) and
     ssb_q2_1_mode (probe x build group, build-side min), each against a
     float64 numpy oracle: in process through a server's join phases
     (each strategy's exec phase, medians of 2 on the host clock), the
     stages apart (host extraction, packing, upload, the device program
     with its build and probe rounds by CUDA events, finalize), the
     program against its plain version, K1 at the join's shape against
     its plain version and bound, a poisoned join plan healing to the
     host join; then two servers and the broker over TCP (broker p50 /
     p99, ssb_q1_1 forced to shuffle, the join cost keys); and on phase
     10's deployed cluster, before its roles stop (role processes,
     partitioning through AddTable,
     ssb_q2_1 colocated over HTTP; its EXPLAIN, the colocated plan with
     nothing sent to a server, and EXPLAIN ANALYZE);
 12. star-tree tables, the reference's two cube configurations
     (pinot_tpu/tools/startree_scale.py:81-127) at full size:
     baseball_cube (4 x 2^23 = 33,554,432 baseballStats rows,
     StarTreeBuilderConfig defaults) and adevents_hll_cube (phase 4's 4
     distinct ad-events segments tiled to 16, one tree per distinct
     segment: split campaign_id, site_id, HLL registers of user_id, 64
     records a leaf): the tree builds on the host (seconds and cube rows
     per segment); sum / count by teamID, filtered by league and yearID,
     and the north-star HLL, from the cube (host clock, median of 10)
     and from K1 / K2 with the trees detached (CUDA events, median of
     10), each against a host oracle and the two against each other (HLL
     and counts identical, sums in the audit band); a max() that is not
     star-fit falls back to K1; a mixed table (trees on half the
     segments) merging the cube's partials with the card's, with the
     staged bytes before and after; the trees written as segment files,
     read back equal and served by two port servers behind the broker
     over TCP (broker p50 / p99 over 20 requests, the cube table and a
     mixed one, and their EXPLAIN, ``explain_checks``);
     ``python -m pinot_tpu_torch.tools.admin CreateSegment -startree`` on
     a 10,000-row CSV and JSONL and ``ShowSegment``, the built segment
     answering against an oracle of the rows; and the pruner's repair: a
     time filter past every ad-events segment pruned to the empty shapes
     with no launch;
 13. the two filter tiers ahead of the scan over phase 1's first 8
     lineitem segments:
     postings for l_shipdate, l_quantity and l_extendedprice built and
     warmed as a server loads its segments (seconds a segment, bytes by
     column, run against packed containers); two ladders with zone_in's
     select list, l_shipdate IN 1, 3, 16, 64 dates (sorted) and
     l_extendedprice BETWEEN one price up to 1/80 of the table
     (unsorted), each at the default route, with postings off (zone
     blocks / a full scan) and with zone maps off too (K1's full scan),
     answers equal, medians of 3, and the measured postings / scan
     crossover; bsi_count_sum and bsi_or_minmax from the bit-sliced tier
     (both decisions taken) against the scan tier exactly, the program by
     CUDA events against its byte bound, its planes' staging and the
     host syncs of one call; batched bit-sliced launches at B = 1, 4, 8,
     each member torch.equal to its solo launch; then the routes line,
     the tier the default executor serves each query of phases 1-13
     from (phases 8 and 10 pass postings=False: mv_filter and the two
     three-date lists route to postings, and those phases hold K1 / K2;
     the deployed cluster serves the three-date lists from postings);
 14. realtime ingestion: lineitem as a REALTIME table consumed by two
     server processes from the port's stream broker, queried at three
     watermarks against oracles of the rows produced, K1 and K2 at a
     server's final shape; each block carries its produce time as its
     event time (``l_eventms``), so every answer carries ``freshnessMs``,
     held against the watermark of the produced events (phase 18 (b));
     after the second watermark the controller is SIGKILLed and restarted
     on its data dir and port (``restart_controller``: READY s, the
     recovery's ms, the epochs, the journal's bytes): both commits run
     through the restarted one, and the last watermark counts every
     produced row once;
 15. residency: one server of the lineitem table behind the broker over
     TCP; q1, distinct_price and hll_groupby staged, then an HBM cap that
     holds two of their three sets: round-robin rounds with every answer
     bit-equal to the uncapped one, K1 / K2 on each promoted table
     against their plain versions, the hot bytes within the cap, each
     promotion against a fresh staging and the copies' rates; the warm
     set spilled to disk and reloaded; a real CUDA out-of-memory error
     (the card filled with filler tensors) healed by demotion on the
     card; EXPLAIN over the tiers and EXPLAIN ANALYZE with K1 / K2 held
     against their plain versions;
 16. the offline build path and schema evolution: 2 of phase 1's lineitem
     segments' first 2^18 rows written as CSV files (vectorized numpy), a
     grown-schema CSV file (2^18 rows, three new columns with values) and
     an Avro file (2^17 rows, deflate); ``BatchCreateSegments -workers 4``
     builds the CSV files (the columnar path, the native parser) and
     pushes them to a deployed cluster (phase 10's roles), each segment's
     CRC equal to ``build_segment_from_columns`` over the file's source
     arrays, with a file's parse / materialization / dictionary and
     forward index / write seconds; q1, count(*) and distinct_price over
     HTTP against their oracles; ``AddSchema`` of the grown schema
     (l_newflag STRING, l_newtags INT_ARRAY, l_newmetric DOUBLE) and the
     reload's wall until every server answers with the default columns
     (no segment loaded again), five queries on them against their
     oracles; two ``StartBuildWorker`` processes build and push the grown
     file and the Avro file, the first killed while it builds and its
     shard retried on the other; the mixed-age table against its
     oracles, the servers' kernel launches moving for each query; then
     the grown schema set on a server over shallow copies of phase 1's
     16 segments: q1 by l_returnflag x l_newflag (K1's fused route with a
     cardinality-1 group column) and distinctcount(l_newflag) (K2) against
     their oracles and plain versions, the default column's staged bytes;
 17. the warm start and the utilization planes: phase 1's first 8
     segments as files through a deployed cluster (phase 10's roles) with
     ``PINOT_TPU_COMPILE_CACHE_DIR`` set to a fresh directory, one server
     holding one segment and the other seven: q1, q3, hll_groupby,
     distinct_price and pct_quantity through the broker against their
     oracles; the servers' ``/debug/plans`` and ``/debug/device``, the
     broker's and the controller's ``/debug/workload`` and the
     controller's ``/debug/utilization`` (equal digests and counts across
     the roles, every roofline fraction at most 1 against the card's
     declared peaks, each digest's static bytes beside ``data_bound``'s
     bytes for its launch over the same segments in process); a
     ``/debug/profile`` capture around queries that must hold K1's and
     K2's kernels by name; the lane's occupancy 0 idle and above 0 under
     queries, from the status reader and the sampler; then the one-segment
     server killed and restarted three times (a fresh plan ledger, the
     same cache root, prewarming from the controller's ``/debug/workload``),
     EXPLAIN's compile state before the first query (cold, persistent,
     prewarmed; ``compile.cold`` 0 after the first restart) and each
     digest's first query (broker ``timeUsedMs``, ``compile.firstCallMs``)
     against the warm p50.  The cache roots hold copies of the main
     build's libraries;
 18. the serving planes: (a) on phase 9's two servers while lineitem is
     staged there: the result cache on (q1, q3, hll_groupby and
     distinct_price twice each: the miss launches K1 / K2 and equals its
     oracle, the hit launches nothing, repeats the miss's bytes and costs
     rescacheHits 1 a server; EXPLAIN's cacheHit; hit against miss p50;
     a re-staged segment's q1 misses and launches K1), the shadow audit
     1-in-1 on q1 and hll_groupby (the host oracle over 134,217,728 rows,
     each "equivalent") and the broker p50 of q1, sel_top, pairs_distinct
     and distinct_price with the default 1-in-64 auditor against it off
     (each oracle in a forked child; the fork's ms), an in-flight cap of 2 and a burst of 8 q1s (the
     excess shed with 429, ``/debug/admission``'s counters); then a
     reduced table (2 segments of 2^20 rows) on both servers: a stalled
     launch hedged to the other server, a wrong answer injected on the
     device tier (``corrupt_results``) caught by the shadow audit,
     quarantined and healed by the host tier with a flight-recorder
     bundle, and the replica audit; (b) phase 14's ``freshnessMs``; (c) on
     phase 17's roles every ``/debug`` surface of the planes with the
     reference's keys, and a table config's ``slo`` block reaching the
     networked broker;
 19. the controller, on phase 17's roles after 18 (c) (``StartController``
     runs the managers and the stabilizer with the reference's defaults,
     in every deployed phase): (a) the controller SIGKILLed and restarted
     on its data dir and port while q1 loops through the broker (partial
     answers while the views refill, none wrong), the recovery's ms, the
     READY s, the seconds until every segment is ONLINE again, the epoch,
     the journal's bytes, then q1, q3, hll_groupby and distinct_price
     against their oracles with K1 / K2 launched on the servers; (b)
     server1 drained over HTTP (the stabilizer moves its segment to
     server0 before its last copy leaves the routing), undrained, and
     ``RebalanceTable`` moving segments back toward 4 / 4 (the old copies
     dropped once the new ones are ONLINE), q1 looped through both moves
     with every answer complete and equal to its oracle, the moves' walls,
     the servers' staged bytes, ``/debug/capacity``'s residency pressure
     and the stabilizer's events; (c) every dashboard page 200 as HTML,
     ``/debug/stabilizer``'s keys, ``ListTenants`` and ``AddTenant``;
 20. Kafka and high-level-consumer ingestion (``kafka_phase``): a stream
     broker process (``StartStreamBroker -kafka-port 0``) and phase 14's
     roles; lineitem rows as JSON messages, 2 partitions a topic: (a) LLC
     over the Kafka wire protocol, 1.5 x 2^18 rows a partition at
     rowsPerSegment 2^18, queried at two watermarks (q1, count(*),
     distinct_price; each row counted exactly once; K1 / K2 launched on the
     servers; one commit a partition); (c) HLC over the Kafka group
     protocol, two members, segments of 2^15 sealing, uploading pinned to
     their server and rolling; (d) gzip, snappy and lz4 message sets, a
     table each, decoded and counted; (b) HLC over the stream broker's
     groups with server1 SIGKILLed mid-stream (the seconds until every
     produced row is counted, at least once); K1 / K2 in process at (a)'s
     sealed segment and Kafka-fed consuming snapshot and at (c)'s sealed
     HLC segment against their plain versions; the hybrid quickstart
     through the CLI and in process;
 21. the link fault plane (``netfaults_phase``): a controller, three
     servers and a broker in this process over HTTP and TCP
     (``NetworkedCluster``), every link through one seeded
     ``NetworkFaultInjector``, the OFFLINE lineitem table as 6 segments of
     2^22 rows at replication 2, and q1 / distinct_price as closed-loop
     load from 4 clients (every complete answer equal to the one before the
     faults, every incomplete one flagged partial): (a) a server cut from
     the controller past its 2.5 s lease (no failed query, nothing moved
     inside the lease); (b) the controller cut from every role (the broker
     serves from its snapshot, the ideal state byte-identical after the
     heal); (c) the replies to one replica of a REALTIME lineitem table fed
     by a file stream (2 partitions of 2^20 rows) lost while its commits
     come due (one commit a partition, by the healthy replica, the same
     CRC on both replicas, count(*) equal to the rows produced); (d) a
     backup while serving, the controller and its property store lost,
     restored, the servers reloaded (every answer equal to the one before,
     the old controller's write refused with StaleEpochError); K1 / K2 at
     a server's shapes against their plain versions;

and between phases 7 and 8 (lineitem still staged): the batched K1 and K2
over ladders of 16 same-plan queries at distinct literals (q1 over
l_shipdate, range_unsorted and distinct_price over l_quantity, hll_price
over l_shipmode), at B = 1, 2, 4, 8, 16 members, every member torch.equal
to its one-member launch, with ms per launch and per member, B
one-member launches, the bound and the plain version; the chunked phase
(config.CHUNK_ROWS = 2^26: q1, torch_op, hll_groupby and pct_quantity in
two chunks of 8 segments against their oracles and the unchunked run);
and the zone-map decision's host ms per query;

every earlier query served by the device (no segmentsHost in its cost),
with the shadow auditor at the deployment's default throughout
(``PINOT_TPU_AUDIT_SAMPLE_N`` unset: 1-in-64);
and times the queries (with their host finalize and the bytes of the one
device-to-host copy), the kernels at each query's shapes, their plain
versions, the torch ops that build their inputs, the one PyTorch call
that computes K2's function, and the pair sort-dedup with both fetches of
its buffers.

    python3 chip_smoke.py [--out results.json]
        [--profile | --kernels-only | --joins-only | --startree-only | --tiers-only
         | --realtime-only | --residency-only | --build-only | --warmstart-only | --planes-only
         | --controller-only | --kafka-only | --netfaults-only]

``--kernels-only`` stops after the build, the kernel checks, the tier
probes and the batched probes (ladders over streams made on the card);
``--joins-only`` runs the build, the kernel checks and phase 11 alone,
``--startree-only`` phase 12 alone, ``--tiers-only`` phase 13 alone (after
lineitem's datagen), ``--realtime-only`` phase 14 alone,
``--residency-only`` phase 15 alone, ``--build-only`` phase 16 alone,
``--warmstart-only`` phase 17 alone and ``--planes-only`` phase 18 (its
part (a) on two servers of lineitem, then phases 14 and 17 with parts (b)
and (c)) and ``--controller-only`` phase 19 (phase 14 with its controller
restart, then phase 17 hosting 18 (c) and 19); each after lineitem's
datagen; ``--kafka-only`` phase 20 alone and ``--netfaults-only`` phase 21
alone (each its own data).

Needs exactly one visible CUDA card (it exits nonzero otherwise).  The last line of
its output is ``{"ok": true, "device": {...}}``; the line before the card
line is the ``{"kernels": [...], "tiers": {...}}`` summary.
"""
from __future__ import annotations

import argparse
import atexit
import bisect
import concurrent.futures
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

Q1 = (
    "SELECT sum(l_quantity), sum(l_extendedprice), sum(l_discount), count(*) "
    "FROM lineitem WHERE l_shipdate <= '1998-09-02' "
    "GROUP BY l_returnflag, l_linestatus TOP 10"
)
Q3 = (
    "SELECT sum(l_extendedprice), sum(l_quantity) FROM lineitem "
    "WHERE l_returnflag = 'R' GROUP BY l_shipmode TOP 10"
)
RANGE = (
    "SELECT sum(l_extendedprice), count(*) FROM lineitem "
    "WHERE l_quantity > 25 GROUP BY l_returnflag TOP 10"
)
QUERIES = {"q1": Q1, "q3": Q3, "range_unsorted": RANGE}
VALUE_QUERIES = {
    # bench.py:198-201, a BASELINE.md shape: HLL lowered to presence, K = 3 x 2048
    "hll_groupby": "SELECT distinctcounthll(l_shipdate) FROM lineitem GROUP BY l_returnflag TOP 10",
    # scalar presence over ~259k global values: K = 2^18, a 32 KB bitmap (K2's block tier)
    "distinct_price": "SELECT distinctcount(l_extendedprice) FROM lineitem WHERE l_quantity > 25",
    # grouped histogram: K = 7 x 56
    "pct_quantity": "SELECT percentile90(l_quantity) FROM lineitem GROUP BY l_shipmode TOP 10",
    # HLL registers from the per-row (bucket, rho) streams: K = 256 x 64
    "hll_price": "SELECT distinctcounthll(l_extendedprice) FROM lineitem WHERE l_shipmode = 'AIR'",
}
# outside K1's fused route (OR tree, min): group sums through K1 over the mask
TORCH_OP_QUERY = (
    "SELECT sum(l_extendedprice), min(l_quantity), count(*) FROM lineitem "
    "WHERE l_quantity > 45 OR l_shipmode = 'AIR' GROUP BY l_returnflag, l_linestatus TOP 10"
)
# selection: first docs; a packed key (~512 rows share each price per
# segment, so doc order breaks the ties); a radix product past x32's 2^30
# key space (262,144 x 2000 x 2000), the lexicographic branch, with an offset
SELECTION_QUERIES = {
    "sel_first": "SELECT l_shipmode, l_extendedprice FROM lineitem WHERE l_shipmode = 'AIR' LIMIT 10",
    "sel_top": "SELECT l_shipdate, l_extendedprice, l_quantity FROM lineitem WHERE l_quantity > 45 "
    "ORDER BY l_extendedprice DESC LIMIT 10",
    "sel_wide": "SELECT * FROM lineitem ORDER BY l_extendedprice, l_shipdate, l_receiptdate LIMIT 5, 10",
}
# exact distinct over (group, value) pairs past the dense holders (2000 x
# 2^18 price ids, 1024 x ~4.26M users, 131,072 x 256 HLL registers > 2^24)
PAIR_QUERIES = {
    "pairs_pct": "SELECT percentile90(l_extendedprice) FROM lineitem WHERE l_quantity = 1 "
    "GROUP BY l_shipdate TOP 10",
    "pairs_distinct": "SELECT distinctcount(l_extendedprice) FROM lineitem WHERE l_quantity = 1 "
    "GROUP BY l_shipdate TOP 10",
    # the exact counterpart of the north-star reach
    "reach_exact": "SELECT distinctcount(user_id) FROM adevents WHERE site_id < 8 GROUP BY campaign_id TOP 10",
    "reach_hll_site": "SELECT distinctcounthll(user_id) FROM adevents WHERE site_id < 8 "
    "GROUP BY campaign_id, site_id TOP 10",
}
AD_QUERIES = ("north_star", "reach_exact", "reach_hll_site")
# NORTHSTAR_HLL.json: 4 distinct ad-events segments of 2^23 rows tiled to 16,
# campaign_card 1024, user_card 2^20 per segment (global ~4.26M users)
NORTH_STAR = "SELECT distinctcounthll(user_id) FROM adevents GROUP BY campaign_id TOP 10"
AD_DISTINCT = 4
AD_CAMPAIGNS = 1024
AD_USERS = 1 << 20
# the host tier: a group space of 2000 x 2000 ship x receipt dates (4,000,000
# > MAX_GROUP_CAPACITY) goes to the host before anything is staged; past
# DISTINCT_PAIR_CAP unique (campaign, user) pairs the device runs (K1, the
# pair reduce) and the host finishes exactly
HOST_QUERIES = {
    "host_groups": "SELECT sum(l_extendedprice), count(*) FROM lineitem WHERE l_quantity > 45 "
    "GROUP BY l_shipdate, l_receiptdate TOP 10",
    "reach_overflow": "SELECT distinctcount(user_id) FROM adevents WHERE site_id < 32 "
    "GROUP BY campaign_id TOP 10",
}
HOST_ITERS = 1  # timed runs per host-tier query: the path's run (3 before phase 13)
# multi-value columns: make_test_schema()'s table (the reference tests'
# default schema), cardinality 1000, 1..3 entries a row, 4 distinct seeded
# segments of 2^23 rows tiled to MV_SEGMENTS; the queries' pool values are
# picked from the global dictionaries at run time ({a}, {b}, ...)
MV_DISTINCT = 4
MV_SEGMENTS = 4  # the distinct segments untiled (16, lineitem's count, before phase 21)
MV_CARDINALITY = 1000
MV_MAX = 3
MV_QUERIES = {
    # MV_ANY: K1 over the evaluated mask
    "mv_filter": "SELECT sum(metDouble), count(*) FROM testTable WHERE dimIntMV IN ({i0}, {i1}, {i2}) "
    "GROUP BY dimStr TOP 10",
    # MV_NONE
    "mv_not": "SELECT count(*), max(metInt) FROM testTable WHERE dimStrMV NOT IN ('{s0}', '{s1}')",
    # the expansion: K1 over each row's MV entries
    "mv_groupby": "SELECT sum(metFloat), count(*) FROM testTable GROUP BY dimStrMV, dimStr TOP 10",
    # K2 over the flattened entries
    "mv_aggs": "SELECT summv(dimIntMV), countmv(dimIntMV), distinctcountmv(dimIntMV), "
    "percentile90mv(dimIntMV), distinctcounthllmv(dimStrMV) FROM testTable",
    # K2 grouped over the flattened entries
    "mv_grouped_state": "SELECT distinctcountmv(dimIntMV) FROM testTable GROUP BY dimStr TOP 10",
}
# 9. serving: the lineitem table split over two servers (8 segments each)
# behind the port's broker over TCP on localhost; 8 concurrent clients send
# the same q1, then q1 at eight distinct l_shipdate literals; the failover
# checks run on a reduced table (2 segments of 2^20 rows) so the host tier
# answers in seconds
SERVE_QUERIES = ("q1", "q3", "hll_groupby", "distinct_price", "sel_top", "pairs_distinct")
SERVE_ITERS = 10  # timed broker requests per query, after warm-up (50 before phase 15, 20 before 17)
SERVE_WARMUP = 3
SERVE_CLIENTS = 8
SERVE_BURSTS = 10  # at most this many bursts of identical q1s until one coalesces
SERVE_DISTINCT_ROUNDS = 3
SERVE_DATES = ("1992-06-15", "1993-03-01", "1993-11-20", "1994-08-08",
               "1995-05-05", "1996-02-14", "1996-10-31", "1997-07-04")
FAILOVER_SEGMENTS = 2
FAILOVER_ROWS = 1 << 20
FAILOVER_STALL_S = 3.0
FAILOVER_STALL_TIMEOUT_S = 1.0
# bench.py:1138-1143, the JAX package's on-chip configuration: 134,217,728 rows
# 10. zone maps and the deployed cluster: a three-date point list on the
# clustered l_shipdate (about 4,194 contiguous rows a date a segment, so at
# most 6 of a segment's 128 zone blocks), through K1 (zone_in) and K2
# (zone_distinct) over the candidate blocks only
ZONE_DATES = ("1993-03-14", "1995-06-14", "1997-09-14")
_ZONE_IN = "('" + "','".join(ZONE_DATES) + "')"
ZONE_QUERIES = {
    "zone_in": "SELECT sum(l_quantity), sum(l_extendedprice), sum(l_discount), count(*) FROM lineitem "
    f"WHERE l_shipdate IN {_ZONE_IN} GROUP BY l_returnflag, l_linestatus TOP 10",
    "zone_distinct": f"SELECT distinctcount(l_extendedprice) FROM lineitem WHERE l_shipdate IN {_ZONE_IN}",
}
# the block path's switch (config.ZONE_MAX_FRACTION) measured on both
# sides: zone_in's and zone_distinct's select lists over clusters of
# l_shipdate dates, each over the blocks (the switch forced open) and as a
# full scan.  (period, dates a cluster): a cluster of every other date
# starts each period dates, so every list has over 64 dictId runs and
# stays a match table (the fused routes' filter), and the candidate
# window grows from 16 of a segment's 128 blocks to all of them
# (zone_in's three dates: 4)
ZONE_SWEEP = ((512, 17), (128, 5), (64, 3), (32, 3), (2, 1))
DEPLOY_QUERIES = SERVE_QUERIES + tuple(ZONE_QUERIES)
DEPLOY_DEVICE = "cuda"  # the role processes' -device
DEPLOY_READY_S = 300.0  # a role process's start, kernel load included
DEPLOY_ONLINE_S = 600.0  # upload to every segment ONLINE in the broker's routing
DEPLOY_REQUEST_S = 600.0  # one HTTP request
# timed requests of zone_distinct, which the servers answer from postings
# through the host tier's row-wise value states (seconds a request): a
# median and a maximum of these few, no p99
DEPLOY_FEW_ITERS = 1  # (5 before phase 15, 2 before 16)

SEGMENTS = 16
ROWS_PER_SEGMENT = 1 << 23
ITERS = 20  # timed runs per median, after warm-up
QUERY_ITERS = 3  # timed runs per whole-query median (ITERS before phase 15, 10 before 16, 5 before 21)
MV_ITERS = 1  # timed runs per mvtest query (mv_groupby takes seconds a run; 5 before phase 14, 3 before 15, 2 before 16)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published HBM3 rate
SCALAR_OPS_PER_S = 67e12  # H100 SXM published float32 rate outside the tensor cores
AUDIT_RTOL, AUDIT_ATOL = 5e-4, 1e-3  # pinot_tpu/utils/audit.py:189-203, float32 reduction order
X64_RTOL, X64_ATOL = 1e-12, 1e-9


LOG_TIMES: List[Tuple[float, str]] = []  # (seconds since import, a log line's head): --out's "log_times"
_T0 = time.perf_counter()


def log(*a):
    msg = " ".join(str(x) for x in a)
    LOG_TIMES.append((round(time.perf_counter() - _T0, 1), msg[:120]))
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, runs: int = 10, expect: str = "value_state_kernel", floor_ms: float = 0.0) -> Dict[str, float]:
    """Device time per call by kernel name (torch.profiler over ``runs``
    calls after a warm-up): what the card spends, without the host work
    of the wrapper that per-call event timing includes.  The profiler
    can lose a window's kernel records: a window that holds fewer than
    ``runs`` records of ``expect``, or whose device work per call reads
    below ``floor_ms`` (the call's byte bound: no run can take less, its
    inputs being far past L2), lost some.  It is traced again, up to
    three times, and then reads NaN."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        out, records = {}, []
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA:
                continue
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = ev.self_cuda_time_total
            if us > 0:
                out[ev.key] = float(us) / runs / 1e3
                if expect in ev.key:
                    records.append(ev.count)
        if records and min(records) >= runs and sum(out.values()) >= floor_ms:
            return out
    return {f"{expect} (records lost by the profiler)": float("nan")}


def cuda_ms(fn, iters: int, warmup: int = 3):
    """Median ms of ``iters`` timed calls (CUDA events around each)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times)), times


def zone_sweep_queries(segment) -> Dict[str, str]:
    """{name: pql}: zone_in's and zone_distinct's select lists filtered on
    the date clusters of ZONE_SWEEP over ``segment``'s l_shipdate
    dictionary."""
    dates = list(segment.column("l_shipdate").dictionary.values)
    out = {}
    for period, count in ZONE_SWEEP:
        pick = [dates[i + 2 * j] for i in range(period // 2, len(dates), period)
                for j in range(count) if i + 2 * j < len(dates)]
        in_list = "('" + "','".join(str(v) for v in pick) + "')"
        for name, pql in ZONE_QUERIES.items():
            out[f"{name}/{period}x{count}"] = pql.replace(_ZONE_IN, in_list)
    return out


# ---------------------------------------------------------------------------
# K1 against its plain version
# ---------------------------------------------------------------------------


def _close(got, want, rtol, atol) -> float:
    """max |got - want|; raises when any element is outside the band."""
    got = got.double().cpu()
    want = want.double().cpu()
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()):
        raise AssertionError(f"sums disagree: max err {float(err.max())}")
    return float(err.max()) if err.numel() else 0.0


def k1_shape(fg, args: dict) -> tuple:
    """(float bytes, K, nv, dict entries, match card, remap entries): what
    picks and sizes K1's tier."""
    fb = 8 if args["dtype"] == torch.float64 else 4
    dicts = sum(d.shape[-1] for d in args["value_dicts"] if d is not None)
    match = args["match"].shape[-1] if args["match"] is not None else 0
    remaps = sum(r.shape[-1] for r in (args.get("group_remaps") or []) if r is not None)
    return fb, args["capacity"], len(args["value_dicts"]), dicts, match, remaps


def k1_tiers(fg, args: dict) -> List[str]:
    """Every accumulation tier that takes these inputs."""
    return [t for t in fg.TIERS if fg.tier_fits(t, *k1_shape(fg, args))]


def compare_k1(fg, args: dict, rtol: float, atol: float) -> Tuple[float, List[str]]:
    """Kernel vs plain version on the same card tensors, in every tier
    that takes the inputs: num_docs and counts exact, sums in the band,
    and two kernel launches bit-identical.  Returns the largest absolute
    sum error and the tiers checked."""
    ref = fg.fused_filtered_groupby_sums_reference(**args)
    err = 0.0
    tiers = k1_tiers(fg, args)
    for tier in tiers:
        a = fg.fused_filtered_groupby_sums(**args, tier=tier)
        b = fg.fused_filtered_groupby_sums(**args, tier=tier)
        torch.cuda.synchronize()
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                and all(torch.equal(x, y) for x, y in zip(a[2], b[2]))):
            raise AssertionError(f"two launches of the fused kernel differ (tier {tier})")
        if int(a[0]) != int(ref[0]):
            raise AssertionError(f"tier {tier}: num_docs {int(a[0])} != {int(ref[0])}")
        if not torch.equal(a[1].cpu(), ref[1].cpu()):
            raise AssertionError(f"tier {tier}: group counts differ from the plain version")
        for x, y in zip(a[2], ref[2]):
            err = max(err, _close(x, y, rtol, atol))
    return err, tiers


def k1_cases(fg, dev, dtype):
    """Filters (interval, table, docrange, single point), value columns
    (dict-fed, raw, none), capacities (1, 6, the shared-memory bound),
    S = 1 and 16, ragged num_docs and an empty segment."""
    g = torch.Generator(device="cpu").manual_seed(1234)
    fb = 8 if dtype == torch.float64 else 4

    def ints(S, n, hi, dt):
        return torch.randint(0, hi, (S, n), generator=g, dtype=torch.int64).to(dt).to(dev)

    def floats(S, n, lo=0.0, hi=100.0):
        return (torch.rand((S, n), generator=g, dtype=torch.float64) * (hi - lo) + lo).to(dtype).to(dev)

    def nd(S, n):
        docs = [n - (i * 997) % (n // 3 + 1) for i in range(S)]
        if S > 1:
            docs[S // 2] = 0  # an empty segment
        return torch.tensor(docs, dtype=torch.int32, device=dev)

    cases = {}
    S, n = 1, 1 << 20
    cases["interval_dict_raw_K6_S1"] = dict(
        filter_fwd=ints(S, n, 2000, torch.int16), match=None, num_docs=nd(S, n),
        group_keys=ints(S, n, 6, torch.int32),
        value_fwds=[ints(S, n, 50, torch.uint8), None], value_dicts=[floats(S, 64), None],
        capacity=6, dtype=dtype, filter_bounds=torch.tensor([[100, 1500]], dtype=torch.int32, device=dev),
        value_raws=[None, floats(S, n, 900.0, 105000.0)],
    )
    S, n = 16, 1 << 16
    cases["table_raw_K6_S16_ragged"] = dict(
        filter_fwd=ints(S, n, 7, torch.uint8), match=(torch.rand((S, 8), generator=g) < 0.5).to(dev),
        num_docs=nd(S, n), group_keys=ints(S, n, 6, torch.int32),
        value_fwds=[None, None, None], value_dicts=[None, None, None],
        capacity=6, dtype=dtype, value_raws=[floats(S, n), floats(S, n), floats(S, n, 0.0, 0.1)],
    )
    lo = torch.randint(0, n // 2, (S, 1), generator=g, dtype=torch.int32)
    cases["docrange_count_only_K1_S16"] = dict(
        filter_fwd=None, match=None, num_docs=nd(S, n), group_keys=ints(S, n, 1, torch.int32),
        value_fwds=[], value_dicts=[], capacity=1, dtype=dtype,
        filter_bounds=torch.cat([lo, lo + n // 3], dim=1).to(dev), value_raws=[],
    )
    S, n = 1, 1 << 20
    cases["single_point_dict_i32_K7_S1"] = dict(
        filter_fwd=ints(S, n, 3, torch.uint8), match=None, num_docs=nd(S, n),
        group_keys=ints(S, n, 7, torch.int32),
        value_fwds=[ints(S, n, 4096, torch.int32)], value_dicts=[floats(S, 4096)],
        capacity=7, dtype=dtype, filter_bounds=torch.tensor([[2, 3]], dtype=torch.int32, device=dev),
        value_raws=[None],
    )
    kmax = fg.max_capacity(fb, 3)
    S, n = 4, 1 << 18
    cases[f"docrange_raw_Kbound{kmax}_S4"] = dict(
        filter_fwd=None, match=None, num_docs=nd(S, n), group_keys=ints(S, n, kmax, torch.int32),
        value_fwds=[None] * 3, value_dicts=[None] * 3, capacity=kmax, dtype=dtype,
        filter_bounds=torch.tensor([[0, n]] * S, dtype=torch.int32, device=dev),
        value_raws=[floats(S, n) for _ in range(3)],
    )

    def unaligned_docrange(S, n):
        lo = torch.randint(0, n // 4, (S, 1), generator=g, dtype=torch.int32) * 4 + 1
        hi = lo + torch.randint(n // 4, n // 2, (S, 1), generator=g, dtype=torch.int32) * 4 + 2
        return torch.cat([lo, hi], dim=1).to(dev)

    def remap(S, card, gcard):
        return torch.randint(0, gcard, (S, card), generator=g, dtype=torch.int32).to(dev)

    # group columns, combined in the kernel: 1, 2 and 3 columns, uint8 /
    # int16 / int32 global-id streams and remap-fed local fwd streams
    S, n = 16, 1 << 16
    cases["groupcols_u8x2_q1like_docrange_unaligned_S16"] = dict(
        filter_fwd=None, match=None, num_docs=nd(S, n), group_keys=None,
        group_cols=[ints(S, n, 3, torch.uint8), ints(S, n, 2, torch.uint8)], group_cards=[3, 2],
        group_remaps=[None, None], value_fwds=[None] * 3, value_dicts=[None] * 3, capacity=6,
        dtype=dtype, filter_bounds=unaligned_docrange(S, n),
        value_raws=[floats(S, n), floats(S, n, 900.0, 105000.0), floats(S, n, 0.0, 0.1)],
    )
    cases["groupcols_u8_i16_i32_table_K24_S4"] = dict(
        filter_fwd=ints(4, n, 7, torch.uint8), match=(torch.rand((4, 8), generator=g) < 0.6).to(dev),
        num_docs=nd(4, n), group_keys=None,
        group_cols=[ints(4, n, 3, torch.uint8), ints(4, n, 4, torch.int16), ints(4, n, 2, torch.int32)],
        group_cards=[3, 4, 2], group_remaps=[None, None, None],
        value_fwds=[None], value_dicts=[None], capacity=24, dtype=dtype, value_raws=[floats(4, n)],
    )
    cases["groupcols_remap_u8_i16_count_only_K350_S4"] = dict(
        filter_fwd=ints(4, n, 200, torch.int16), match=None, num_docs=nd(4, n), group_keys=None,
        group_cols=[ints(4, n, 8, torch.uint8), ints(4, n, 300, torch.int16)], group_cards=[7, 50],
        group_remaps=[remap(4, 8, 7), remap(4, 300, 50)], value_fwds=[], value_dicts=[],
        capacity=350, dtype=dtype,
        filter_bounds=torch.tensor([[20, 150]] * 4, dtype=torch.int32, device=dev),
        value_raws=[],
    )
    cases["groupcols_remap_i32_dict_interval_K9_S2"] = dict(
        filter_fwd=ints(2, n, 50, torch.uint8), match=None, num_docs=nd(2, n), group_keys=None,
        group_cols=[ints(2, n, 12, torch.int32)], group_cards=[9], group_remaps=[remap(2, 12, 9)],
        value_fwds=[ints(2, n, 40, torch.uint8)], value_dicts=[floats(2, 40)], capacity=9, dtype=dtype,
        filter_bounds=torch.tensor([[25, 50], [0, 10]], dtype=torch.int32, device=dev), value_raws=[None],
    )
    # the private tier's boundary: the largest K it takes with one value
    # column, and one more (another tier)
    kp = max(k for k in range(1, 4096) if fg.shared_bytes("private", fb, k, 1) <= fg.PRIVATE_SHARED_BYTES)
    for K in (kp, kp + 1):
        cases[f"private_boundary_K{K}_{fg.choose_tier(fb, K, 1)}_S4"] = dict(
            filter_fwd=ints(4, n, 7, torch.uint8), match=None, num_docs=nd(4, n),
            group_keys=ints(4, n, K + 2, torch.int32), value_fwds=[None], value_dicts=[None],
            capacity=K, dtype=dtype, filter_bounds=torch.tensor([[1, 6]] * 4, dtype=torch.int32, device=dev),
            value_raws=[floats(4, n)],
        )
    # count-only at north_star's K over a mask-as-match-table filter
    S, n = 16, 1 << 15
    cases["mask_table_count_only_K1024_S16"] = dict(
        filter_fwd=ints(S, n, 2, torch.uint8), match=torch.tensor([[False, True]] * S, device=dev),
        num_docs=nd(S, n), group_keys=ints(S, n, 1024, torch.int32), value_fwds=[], value_dicts=[],
        capacity=1024, dtype=dtype, value_raws=[],
    )
    # n_pad not a multiple of 16 (vector body with a partial chunk) and
    # not a multiple of 4 (every row through the scalar loop), ragged
    # num_docs with an empty segment; n_pad = 8
    for n in (1000, 1001, 8):
        S = 3
        docs = torch.tensor([n, max(0, n - 5), 0], dtype=torch.int32, device=dev)
        cases[f"npad{n}_groupcols_S3_ragged"] = dict(
            filter_fwd=ints(S, n, 7, torch.int32), match=None, num_docs=docs, group_keys=None,
            group_cols=[ints(S, n, 3, torch.uint8), ints(S, n, 5, torch.int16)], group_cards=[3, 5],
            group_remaps=[None, None], value_fwds=[ints(S, n, 20, torch.int16), None],
            value_dicts=[floats(S, 20), None], capacity=15, dtype=dtype,
            filter_bounds=torch.tensor([[1, 6]] * S, dtype=torch.int32, device=dev),
            value_raws=[None, floats(S, n)],
        )
    return cases


def block_table(S: int, n_pad: int, block: int, g, dev) -> torch.Tensor:
    """A random block table: per segment an ascending subset of the
    n_pad // block zone blocks (at most half of them, -1 padded), the
    second segment with none."""
    nb = n_pad // block
    nb_pad = max(1, nb // 2)
    ids = torch.full((S, nb_pad), -1, dtype=torch.int32)
    for s_ in range(S):
        if s_ == 1:
            continue
        k = int(torch.randint(1, nb_pad + 1, (1,), generator=g))
        ids[s_, :k] = torch.sort(torch.randperm(nb, generator=g)[:k]).values.to(torch.int32)
    return ids.to(dev)


# K1 and K2 cases that also run over a block table, with its block size:
# a multiple of the kernels' 512-row warp chunk, a smaller one, and
# blocks at n_pad % 4 != 0 (every row through the one-row loop)
K1_BLOCK_CASES = {
    "table_raw_K6_S16_ragged": 4096,
    "groupcols_u8x2_q1like_docrange_unaligned_S16": 256,
    "groupcols_remap_u8_i16_count_only_K350_S4": 1024,
    "interval_dict_raw_K6_S1": 65536,
    "npad1000_groupcols_S3_ragged": 200,
    "npad1001_groupcols_S3_ragged": 143,
}
K2_BLOCK_CASES = {
    "counts_mask_g1_u8gids_W56_S16": 4096,
    "presence_docrange_g1_i32gids_W524288_S16": 256,
    "registers_table_scalar_streams_S16": 2048,
    "presence_interval_scalar_i32gids_W262144_S16": 8192,
    "counts_npad1000_interval_g2remap_S3": 200,
    "presence_npad1001_interval_g2remap_S3": 143,
}


def with_block_tables(cases: dict, picks: Dict[str, int], dev, k2: bool = False) -> dict:
    """``cases`` plus, for each picked case, the same arguments over a
    random block table."""
    g = torch.Generator(device="cpu").manual_seed(97)
    out = dict(cases)
    for name, block in picks.items():
        mode, args = cases[name] if k2 else (None, cases[name])
        lead = args["values"] if k2 else (args["group_keys"] if args["group_keys"] is not None
                                         else args["group_cols"][0])
        S, n_pad = lead.shape
        blk = dict(args, block_ids=block_table(S, n_pad, block, g, dev), block_rows=block)
        out[f"{name}_blocks{block}"] = (mode, blk) if k2 else blk
    return out


def k1_probe_shapes(dev) -> Dict[str, dict]:
    """K1 inputs at the main path's widths (SEGMENTS x ROWS_PER_SEGMENT,
    x32), made on the card from a seed: q1's (two uint8 group columns,
    docrange, three raw floats), the same with a precombined key, and the
    count-only launches over a {0, 1} mask at K = 3 and 1024."""
    g = torch.Generator(device=dev).manual_seed(99)
    S, n = SEGMENTS, ROWS_PER_SEGMENT
    u8 = lambda hi: torch.randint(0, hi, (S, n), generator=g, device=dev, dtype=torch.uint8)  # noqa: E731
    f32 = lambda: torch.rand((S, n), generator=g, device=dev, dtype=torch.float32)  # noqa: E731
    nd = torch.full((S,), n, dtype=torch.int32, device=dev)
    rf, ls = u8(3), u8(2)
    q1 = dict(filter_fwd=None, match=None, num_docs=nd, group_keys=None, group_cols=[rf, ls],
              group_cards=[3, 2], group_remaps=[None, None], value_fwds=[None] * 3,
              value_dicts=[None] * 3, capacity=6, dtype=torch.float32,
              filter_bounds=torch.tensor([[0, n - 1000]] * S, dtype=torch.int32, device=dev),
              value_raws=[f32(), f32(), f32()])
    keyed = dict(q1, group_keys=(rf.int() * 2 + ls.int()).contiguous(), group_cols=None,
                 group_cards=None, group_remaps=None)
    mask = u8(2)
    match = torch.tensor([[False, True]] * S, device=dev)
    count = lambda K: dict(  # noqa: E731
        filter_fwd=mask, match=match, num_docs=nd,
        group_keys=torch.randint(0, K, (S, n), generator=g, device=dev, dtype=torch.int32),
        value_fwds=[], value_dicts=[], capacity=K, dtype=torch.float32, value_raws=[])
    return {"q1_group_cols": q1, "q1_precombined_key": keyed, "count_only_K3": count(3),
            "count_only_K1024": count(1024)}


# ---------------------------------------------------------------------------
# The float64 host oracle
# ---------------------------------------------------------------------------


def _labels(seg, col):
    """(per-row label index, sorted label list) for a string column."""
    d = seg.column(col).dictionary
    return seg.column(col).fwd, list(d.values)


def oracle(segments, name):
    """{group tuple: {"count": int, <agg display name>: float}} in float64
    from the host segments, independently of the engine."""
    acc = {}

    def add(keys, mask, labels, sums):
        sel = keys[mask]
        cnt = np.bincount(sel, minlength=len(labels))
        tot = {k: np.bincount(sel, weights=v[mask], minlength=len(labels)) for k, v in sums.items()}
        for i, lab in enumerate(labels):
            if cnt[i] == 0:
                continue
            e = acc.setdefault(lab, {"count": 0, **{k: 0.0 for k in sums}})
            e["count"] += int(cnt[i])
            for k in sums:
                e[k] += float(tot[k][i])

    for seg in segments:
        def vals(col):
            c = seg.column(col)
            return np.asarray(c.dictionary.values, dtype=np.float64)[c.fwd]

        if name == "q1":
            c = seg.column("l_shipdate")
            ok = np.array([v <= "1998-09-02" for v in c.dictionary.values])
            mask = ok[c.fwd]
            rf, rfl = _labels(seg, "l_returnflag")
            ls, lsl = _labels(seg, "l_linestatus")
            keys = rf.astype(np.int64) * len(lsl) + ls
            labels = [(a, b) for a in rfl for b in lsl]
            add(keys, mask, labels, {
                "sum_l_quantity": vals("l_quantity"),
                "sum_l_extendedprice": vals("l_extendedprice"),
                "sum_l_discount": vals("l_discount"),
            })
        elif name == "q3":
            c = seg.column("l_returnflag")
            mask = np.array([v == "R" for v in c.dictionary.values])[c.fwd]
            sm, sml = _labels(seg, "l_shipmode")
            add(sm.astype(np.int64), mask, [(x,) for x in sml], {
                "sum_l_extendedprice": vals("l_extendedprice"),
                "sum_l_quantity": vals("l_quantity"),
            })
        elif name == "zone_in":
            c = seg.column("l_shipdate")
            mask = np.isin(np.asarray(c.dictionary.values, dtype=object), list(ZONE_DATES))[c.fwd]
            rf, rfl = _labels(seg, "l_returnflag")
            ls, lsl = _labels(seg, "l_linestatus")
            keys = rf.astype(np.int64) * len(lsl) + ls
            add(keys, mask, [(a, b) for a in rfl for b in lsl], {
                "sum_l_quantity": vals("l_quantity"),
                "sum_l_extendedprice": vals("l_extendedprice"),
                "sum_l_discount": vals("l_discount"),
            })
        elif name == "range_unsorted":
            mask = vals("l_quantity") > 25
            rf, rfl = _labels(seg, "l_returnflag")
            add(rf.astype(np.int64), mask, [(x,) for x in rfl], {
                "sum_l_extendedprice": vals("l_extendedprice"),
            })
        else:  # torch_op
            sm = seg.column("l_shipmode")
            qty = vals("l_quantity")
            mask = (qty > 45) | np.array([v == "AIR" for v in sm.dictionary.values])[sm.fwd]
            rf, rfl = _labels(seg, "l_returnflag")
            ls, lsl = _labels(seg, "l_linestatus")
            keys = rf.astype(np.int64) * len(lsl) + ls
            add(keys, mask, [(a, b) for a in rfl for b in lsl], {
                "sum_l_extendedprice": vals("l_extendedprice"),
            })
            for k, lab in enumerate([(a, b) for a in rfl for b in lsl]):
                sel = qty[mask & (keys == k)]
                if sel.size:
                    e = acc[lab]
                    e["min_l_quantity"] = min(e.get("min_l_quantity", math.inf), float(sel.min()))
    return acc


def check_response(resp, want) -> float:
    """Counts and groups exact, sums within the audit band; returns the
    largest relative sum error."""
    worst = 0.0
    for ar in resp.aggregation_results:
        got = {tuple(g.group): g.value for g in ar.group_by_result}
        if set(got) != set(want):
            raise AssertionError(f"{ar.function}: groups {sorted(got)} != {sorted(want)}")
        for key, v in got.items():
            if ar.function == "count_star":
                if int(v) != want[key]["count"]:
                    raise AssertionError(f"count {key}: {v} != {want[key]['count']}")
                continue
            if ar.function.startswith("min_"):
                if float(v) != want[key][ar.function]:
                    raise AssertionError(f"{ar.function} {key}: {v} != {want[key][ar.function]}")
                continue
            w = want[key][ar.function]
            if not math.isclose(float(v), w, rel_tol=AUDIT_RTOL, abs_tol=AUDIT_ATOL):
                raise AssertionError(f"{ar.function} {key}: {v} vs oracle {w}")
            worst = max(worst, abs(float(v) - w) / max(abs(w), 1e-30))
    return worst


def response_as_want(resp) -> Dict[Tuple[str, ...], Dict[str, Any]]:
    """A grouped response in ``oracle``'s form, to hold another response
    to it with ``check_response``."""
    want: Dict[Tuple[str, ...], Dict[str, Any]] = {}
    for ar in resp.aggregation_results:
        for g in ar.group_by_result:
            count = ar.function == "count_star"
            want.setdefault(tuple(g.group), {})["count" if count else ar.function] = \
                int(g.value) if count else float(g.value)
    return want


def rows_read(args: dict, lo: torch.Tensor, hi: torch.Tensor) -> int:
    """Rows a kernel must read: per segment the rows in [lo, hi), and with
    a block table only those inside its candidate blocks."""
    lo, hi = lo.long().cpu(), hi.long().cpu()
    ids = args.get("block_ids")
    if ids is None:
        return int((hi - lo).clamp(min=0).sum())
    blk = int(args["block_rows"])
    b = ids.long().cpu()
    start, end = b * blk, (b + 1) * blk
    span = (torch.minimum(end, hi[:, None]) - torch.maximum(start, lo[:, None])).clamp(min=0)
    return int(torch.where(b >= 0, span, 0).sum())


def k1_bytes(args: dict):
    """(rows, bytes, bytes per row) K1 must read and move for these
    inputs: every row it has to read (rows below num_docs, inside the doc
    interval for docrange, inside the candidate blocks with a block
    table) read once per input, each dictionary / match table once,
    outputs written once.  The key costs its precombined int32 stream, or,
    when the kernel combines it, each group column's own width and each
    remap table once."""
    nd = args["num_docs"].long().cpu()
    lead = args["group_keys"] if args["group_keys"] is not None else args["group_cols"][0]
    n_pad = lead.shape[1]
    if args["filter_fwd"] is None:
        b = args["filter_bounds"].long().cpu()
        rows = rows_read(args, b[:, 0].clamp(min=0), torch.minimum(b[:, 1], nd))
        per_row = 0
    else:
        rows = rows_read(args, torch.zeros_like(nd), nd.clamp(max=n_pad))
        per_row = args["filter_fwd"].element_size()
    tables = 0 if args.get("block_ids") is None else args["block_ids"].numel() * 4
    if args["group_keys"] is not None:
        per_row += 4  # int32 group key
    else:
        for g, r in zip(args["group_cols"], args.get("group_remaps") or [None] * len(args["group_cols"])):
            per_row += g.element_size()
            if r is not None:
                tables += r.numel() * r.element_size()
    for f, d, r in zip(args["value_fwds"], args["value_dicts"], args["value_raws"]):
        if r is not None:
            per_row += r.element_size()
        else:
            per_row += f.element_size()
            tables += d.numel() * d.element_size()
    if args["match"] is not None:
        tables += args["match"].numel()
    fb = 8 if args["dtype"] == torch.float64 else 4
    K = args["capacity"]
    out = 8 + 8 * K + fb * K * len(args["value_raws"])
    return rows, rows * per_row + tables + out, per_row


def data_bound(rows: int, nbytes: int, per_row: int, ops: int, row_ops: int, args: dict,
               matched: Optional[int]) -> Tuple[int, int]:
    """(bytes, operations) this run's data needs.  With ``matched``, the
    call's matched-row count: the filter stream and its test for every row
    read, every other stream and operation for the matched rows only (a
    kernel that reads a row's other streams only where its filter passes
    needs no more).  Without it, every stream of every row read."""
    if matched is None:
        return nbytes, ops
    has_filter = args.get("filter_fwd") is not None
    fb = args["filter_fwd"].element_size() if has_filter else 0
    skipped = rows - matched
    return nbytes - skipped * (per_row - fb), ops - skipped * (row_ops - (2 if has_filter else 0))


def k1_bound(args: dict, matched: Optional[int] = None):
    """(bound ms, "bytes" or "operations", bytes, operations) for these
    inputs: the larger of the bytes over the memory rate and the scalar
    operations over the non-tensor-core rate, for the rows ``data_bound``
    counts.  Operations per row: the filter test (two compares; none for
    docrange, whose rows outside the interval are never read), the key
    combine (a multiply and an add per group column past the first), the
    key range check (two), the count add and one add per value column."""
    rows, nbytes, per_row = k1_bytes(args)
    combine = 0 if args["group_keys"] is not None else 2 * (len(args["group_cols"]) - 1)
    row_ops = (0 if args["filter_fwd"] is None else 2) + combine + 3 + len(args["value_raws"])
    nbytes, ops = data_bound(rows, nbytes, per_row, rows * row_ops, row_ops, args, matched)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


# ---------------------------------------------------------------------------
# K2 against its plain version
# ---------------------------------------------------------------------------


def k2_cases(dev):
    """K = 300, 1024, 6144, 16384 and 2^18 over S = 16 segments with ragged
    num_docs (the tail past each carries the sentinel) and 5 % sentinel
    entries; one hot bin at S = 1; 8 hot bins at K = 2^18 (device-memory
    counts, matched across the warp); an all-sentinel stream; an empty stream;
    a stream starting 4 bytes past an aligned address, of odd length, with
    indexes below 0 and above K."""
    g = torch.Generator(device="cpu").manual_seed(4321)
    cases = {}
    S, n = 16, 1 << 16
    for K in (300, 1024, 6144, 16384, 1 << 18):
        idx = torch.randint(0, K, (S, n), generator=g, dtype=torch.int32)
        idx[torch.rand((S, n), generator=g) < 0.05] = K
        for s in range(S):
            idx[s, n - (s * 997) % (n // 3 + 1):] = K
        cases[f"K{K}_S16_ragged_5pct_sentinel"] = (idx.to(dev), K)
    hot = torch.randint(0, 300, (1, 1 << 22), generator=g, dtype=torch.int32)
    hot[torch.rand((1, 1 << 22), generator=g) < 0.9] = 7
    cases["K300_S1_hot_bin"] = (hot.to(dev), 300)
    # device-memory counts (K = 2^18), 90 % of the rows on 8 hot bins
    wide = torch.randint(0, 1 << 18, (1, 1 << 22), generator=g, dtype=torch.int32)
    on_hot = torch.rand((1, 1 << 22), generator=g) < 0.9
    wide[on_hot] = torch.randint(0, 8, (int(on_hot.sum()),), generator=g, dtype=torch.int32) * 4099
    cases["K262144_S1_8_hot_bins"] = (wide.to(dev), 1 << 18)
    cases["K16384_S1_all_sentinel"] = (torch.full((1, 1 << 20), 16384, dtype=torch.int32, device=dev), 16384)
    cases["K1024_empty"] = (torch.zeros(0, dtype=torch.int32, device=dev), 1024)
    odd = torch.randint(-3, 6147, ((1 << 20) + 7,), generator=g, dtype=torch.int32).to(dev)
    cases["K6144_unaligned_odd_out_of_range"] = (odd[1:], 6144)
    return cases


def compare_k2(vsc, idx, K: int) -> Tuple[float, List[str]]:
    """The precombined form in every tier that takes K vs torch.bincount
    over the in-range entries and vs the plain version: bit-equal, and
    two launches bit-identical.  Returns the largest absolute difference
    from the plain version (0) and the tiers checked."""
    flat = idx.reshape(-1)
    want = torch.bincount(flat[(flat >= 0) & (flat < K)], minlength=K)
    ref = vsc.value_state_counts_reference(idx, K)
    tiers = [t for t in vsc.MODE_TIERS["counts"] if vsc.tier_fits("counts", t, K)]
    for tier in tiers:
        a = vsc.value_state_counts(idx, K, tier=tier)
        b = vsc.value_state_counts(idx, K, tier=tier)
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"two launches of the value-state kernel differ (tier {tier})")
        if not torch.equal(a, want):
            raise AssertionError(f"counts differ from torch.bincount (K={K}, tier {tier})")
        if not torch.equal(a, ref):
            raise AssertionError(f"counts differ from the plain version (K={K}, tier {tier})")
    return 0.0, tiers


def k2_index_bound(idx, K: int):
    """The precombined form's (bound ms, "bytes" or "operations", bytes,
    operations): each index read once (4 B) and each int64 count written
    once; about three integer operations per index (the range test and
    the add).  For a query this is the bound of the combined index the
    route no longer builds ("old bound")."""
    nbytes = 4 * idx.numel() + 8 * K
    ops = 3 * idx.numel()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def k2_tables(args: dict) -> list:
    """The lookup tables of a value_state call, in the kernel's order."""
    return [*(args.get("group_remaps") or [])] + [args.get("value_table"), args.get("rho_table")]


def k2_tiers(vsc, mode: str, args: dict) -> List[str]:
    """Every tier of ``mode`` that takes these inputs."""
    K = vsc.index_space(mode, args.get("capacity", 1), args.get("width"))
    tb = vsc.shared_table_bytes(k2_tables(args))
    mc = args["match"].shape[-1] if args.get("match") is not None else 0
    return [t for t in vsc.MODE_TIERS[mode] if vsc.tier_fits(mode, t, K, tb, mc)]


def compare_k2_value(vsc, mode: str, args: dict) -> List[str]:
    """value_state in every tier that takes the inputs vs its plain
    version on the same card tensors: docs and holder bit-equal, and two
    launches bit-identical.  Returns the tiers checked."""
    ref_docs, ref = vsc.value_state_reference(mode, **args)
    tiers = k2_tiers(vsc, mode, args)
    for tier in tiers:
        a = vsc.value_state(mode, **args, tier=tier)
        b = vsc.value_state(mode, **args, tier=tier)
        torch.cuda.synchronize()
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            raise AssertionError(f"two launches of value_state differ ({mode}, tier {tier})")
        if int(a[0]) != int(ref_docs):
            raise AssertionError(f"{mode} tier {tier}: docs {int(a[0])} != {int(ref_docs)}")
        if a[1].dtype != ref.dtype or not torch.equal(a[1], ref):
            raise AssertionError(f"{mode} tier {tier}: holder differs from the plain version")
    return tiers


def check_k2_empty(vsc, dev) -> None:
    """value_state over no rows, in each mode: zero holders of the plain
    version's dtype and shape, and no launch."""
    nd = torch.zeros(2, dtype=torch.int32, device=dev)
    v = torch.zeros((2, 0), dtype=torch.uint8, device=dev)
    for mode, kw in (("counts", dict(width=56, capacity=7)), ("presence", dict(width=64)),
                     ("registers", dict(rho=v))):
        before = vsc.launches
        docs, holder = vsc.value_state(mode, nd, v, **kw)
        ref_docs, ref = vsc.value_state_reference(mode, nd, v, **kw)
        if vsc.launches != before:
            raise AssertionError(f"value_state launched over no rows ({mode})")
        if int(docs) != int(ref_docs) or holder.dtype != ref.dtype or not torch.equal(holder, ref):
            raise AssertionError(f"value_state over no rows differs from the plain version ({mode})")


def k2_value_cases(dev) -> Dict[str, Tuple[str, dict]]:
    """value_state in each mode over each filter form (none, interval,
    docrange with an unaligned start, match table, the {0, 1} mask), group
    form (none, one uint8 column, two columns with a remap-fed int16) and
    value form (int16 / int32 global ids, fwd + remap with ids past the
    table, the uint8 (bucket, rho) streams, fwd + bucket / rho tables in
    shared and in device memory), over 16 x 2^16 rows with ragged
    num_docs and an empty segment; and n_pad 1000 / 1001 / 8 (the
    one-row head and tail loop)."""
    g = torch.Generator(device="cpu").manual_seed(2468)

    def ints(S, n, hi, dt):
        return torch.randint(0, hi, (S, n), generator=g, dtype=torch.int64).to(dt).to(dev)

    def table(S, card, hi):
        return torch.randint(0, hi, (S, card), generator=g, dtype=torch.int32).to(dev)

    def nd(S, n):
        docs = [n - (i * 997) % (n // 3 + 1) for i in range(S)]
        if S > 1:
            docs[S // 2] = 0  # an empty segment
        return torch.tensor(docs, dtype=torch.int32, device=dev)

    def filters(S, n):
        mask = (torch.rand((S, n), generator=g) < 0.6).to(dev)
        lo = torch.randint(0, n // 4, (S, 1), generator=g, dtype=torch.int32) * 4 + 1
        return {
            "none": {},
            "mask": dict(filter_fwd=mask.view(torch.uint8), match=torch.tensor([[False, True]] * S, device=dev)),
            "docrange": dict(filter_bounds=torch.cat([lo, lo + n // 2 + 3], dim=1).to(dev)),
            "interval": dict(filter_fwd=ints(S, n, 300, torch.int16),
                             filter_bounds=torch.tensor([[40, 220]] * S, dtype=torch.int32, device=dev)),
            "table": dict(filter_fwd=ints(S, n, 7, torch.uint8),
                          match=(torch.rand((S, 8), generator=g) < 0.5).to(dev)),
        }

    def groups(S, n):
        return {
            "scalar": dict(capacity=1),
            "g1": dict(group_cols=[ints(S, n, 7, torch.uint8)], group_cards=[7], group_remaps=[None], capacity=7),
            "g2remap": dict(group_cols=[ints(S, n, 3, torch.uint8), ints(S, n, 310, torch.int16)],
                            group_cards=[3, 50], group_remaps=[None, table(S, 300, 50)], capacity=150),
        }

    cases = {}
    S, n = 16, 1 << 16
    F, G = filters(S, n), groups(S, n)
    base = dict(num_docs=nd(S, n))
    plan = [
        # (mode, filter, group, value form)
        ("counts", "none", "scalar", "i16gids_W2560"),
        ("counts", "mask", "g1", "u8gids_W56"),
        ("counts", "interval", "g2remap", "fwd_remap_W64"),
        ("counts", "docrange", "scalar", "i32gids_W131072"),
        ("counts", "table", "g1", "i16gids_W2560"),
        ("presence", "interval", "scalar", "i32gids_W262144"),
        ("presence", "none", "g1", "i16gids_W2560"),
        ("presence", "table", "g2remap", "fwd_remap_W4096"),
        ("presence", "docrange", "g1", "i32gids_W524288"),
        ("presence", "mask", "scalar", "fwd_remap_W64"),
        ("registers", "table", "scalar", "streams"),
        ("registers", "mask", "g1", "streams"),
        ("registers", "interval", "scalar", "fwd_tables_shared"),
        ("registers", "none", "g2remap", "fwd_tables_global"),
        ("registers", "docrange", "g1", "fwd_tables_shared"),
    ]

    def values(form, S, n):
        if form.startswith(("i16gids", "i32gids", "u8gids")):
            W = int(form.split("_W")[1])
            dt = {"i16": torch.int16, "i32": torch.int32, "u8": torch.uint8}[form.split("gids")[0]]
            return dict(values=ints(S, n, W, dt), width=W)
        if form.startswith("fwd_remap"):
            W = int(form.split("_W")[1])
            return dict(values=ints(S, n, 510, torch.int16), value_table=table(S, 500, W), width=W)
        if form == "streams":
            return dict(values=ints(S, n, 256, torch.uint8), rho=ints(S, n, 33, torch.uint8))
        card = 1000 if form == "fwd_tables_shared" else 8192  # 8 KB of tables in shared memory, 64 KB not
        return dict(values=ints(S, n, card + 5, torch.int16 if card < 32767 else torch.int32),
                    value_table=table(S, card, 256), rho_table=table(S, card, 40))

    for mode, f, gr, v in plan:
        cases[f"{mode}_{f}_{gr}_{v}_S16"] = (mode, {**base, **F[f], **G[gr], **values(v, S, n)})
    # n_pad not a multiple of 16 (a partial chunk) and not of 4 (every row
    # through the one-row loop), ragged num_docs with an empty segment
    for n, mode in ((1000, "counts"), (1001, "presence"), (8, "registers"), (1001, "counts")):
        S = 3
        docs = torch.tensor([n, max(0, n - 5), 0], dtype=torch.int32, device=dev)
        F, G = filters(S, n), groups(S, n)
        v = values("streams" if mode == "registers" else "fwd_remap_W64", S, n)
        cases[f"{mode}_npad{n}_interval_g2remap_S3"] = (mode, dict(num_docs=docs, **F["interval"], **G["g2remap"], **v))
    return cases


def k2_probe_shapes(dev) -> Dict[str, Tuple[str, dict]]:
    """value_state inputs at the main path's four launch shapes
    (SEGMENTS x ROWS_PER_SEGMENT, the lineitem cardinalities), made on the
    card from a seed: hll_groupby's presence over int16 dates by a uint8
    flag, distinct_price's presence over int32 prices under a uint8
    interval, pct_quantity's histogram over uint8 quantities by a uint8
    mode, hll_price's registers from the (bucket, rho) streams under a
    match table; pct_quantity's shape with 90 % of the rows on one
    quantity (7 hot bins), where the block histogram's shared atomics meet
    on the same addresses; and the histogram of percentile90(
    l_extendedprice), int64 counts over 2^18 price ids in device memory
    (the global tier), uniform and with 90 % of the rows on 8 prices."""
    g = torch.Generator(device=dev).manual_seed(98)
    S, n = SEGMENTS, ROWS_PER_SEGMENT
    ints = lambda hi, dt: torch.randint(0, hi, (S, n), generator=g, device=dev, dtype=torch.int64).to(dt)  # noqa: E731
    nd = torch.full((S,), n, dtype=torch.int32, device=dev)
    u8 = lambda hi: torch.randint(0, hi, (S, n), generator=g, device=dev, dtype=torch.uint8)  # noqa: E731
    rho = torch.clamp(torch.distributions.Geometric(probs=torch.tensor(0.5, device=dev)).sample((S, n)), max=40)
    match = torch.zeros((S, 8), dtype=torch.bool, device=dev)
    match[:, 0] = True
    return {
        "hll_groupby": ("presence", dict(num_docs=nd, values=ints(2000, torch.int16), width=2048, capacity=3,
                                         group_cols=[u8(3)], group_cards=[3], group_remaps=[None])),
        "distinct_price": ("presence", dict(num_docs=nd, values=ints(258838, torch.int32), width=262144,
                                            filter_fwd=u8(50),
                                            filter_bounds=torch.tensor([[25, 50]] * S, dtype=torch.int32, device=dev))),
        "pct_quantity": ("counts", dict(num_docs=nd, values=u8(50), width=56, capacity=7,
                                        group_cols=[u8(7)], group_cards=[7], group_remaps=[None])),
        "hll_price": ("registers", dict(num_docs=nd, values=u8(255), rho=(rho + 1).to(torch.uint8),
                                        filter_fwd=u8(7), match=match)),
        "pct_quantity_hot_bins": ("counts", dict(
            num_docs=nd, values=torch.where(torch.rand((S, n), generator=g, device=dev) < 0.9, 0, u8(50)),
            width=56, capacity=7, group_cols=[u8(7)], group_cards=[7], group_remaps=[None])),
        "pct_price": ("counts", dict(num_docs=nd, values=ints(258838, torch.int32), width=262144)),
        "pct_price_hot_bins": ("counts", dict(
            num_docs=nd, values=torch.where(torch.rand((S, n), generator=g, device=dev) < 0.9,
                                            ints(8, torch.int32) * 4099, ints(258838, torch.int32)),
            width=262144)),
    }


def k2_bytes(vsc, mode: str, args: dict):
    """(rows, bytes, bytes per row) value_state must read and move for
    these inputs: every row it has to read (rows below num_docs, inside
    the doc interval for docrange, inside the candidate blocks with a
    block table) once per stream it reads (filter,
    group columns, values, rho), each table once, the holder written
    once."""
    nd = args["num_docs"].long().cpu()
    n_pad = args["values"].shape[1]
    per_row = 0
    if args.get("filter_fwd") is None and args.get("filter_bounds") is not None:
        b = args["filter_bounds"].long().cpu()
        rows = rows_read(args, b[:, 0].clamp(min=0), torch.minimum(b[:, 1], nd))
    else:
        rows = rows_read(args, torch.zeros_like(nd), nd.clamp(max=n_pad))
    for t in (args.get("filter_fwd"), *(args.get("group_cols") or []), args["values"], args.get("rho")):
        if t is not None:
            per_row += t.element_size()
    tables = sum(t.numel() * t.element_size() for t in k2_tables(args) if t is not None)
    if args.get("block_ids") is not None:
        tables += args["block_ids"].numel() * 4
    if args.get("match") is not None:
        tables += args["match"].numel()
    K = vsc.index_space(mode, args.get("capacity", 1), args.get("width"))
    out = 8 + (8 * K if mode == "counts" else 4 * K if mode == "presence" else K // 64)
    return rows, rows * per_row + tables + out, per_row


def k2_bound(vsc, mode: str, args: dict, matched: Optional[int] = None):
    """(bound ms, "bytes" or "operations", bytes, operations): the bytes of
    ``k2_bytes`` over the memory rate, or the integer operations per row
    (two for the filter test, a multiply and an add per group column and
    for the value, two more for rho, the range test and the update) over
    the non-tensor-core rate, for the rows ``data_bound`` counts."""
    rows, nbytes, per_row = k2_bytes(vsc, mode, args)
    row_ops = (2 if args.get("filter_fwd") is not None else 0) + 2 * len(args.get("group_cols") or []) + 2 \
        + (2 if mode == "registers" else 0) + 2
    nbytes, ops = data_bound(rows, nbytes, per_row, rows * row_ops, row_ops, args, matched)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


# ---------------------------------------------------------------------------
# Batched K1 / K2: B same-plan members in one launch
# ---------------------------------------------------------------------------

# the member counts each batched probe launches (every member torch.equal
# to its own one-member launch at each)
BATCH_SIZES = (1, 2, 4, 8, 16)
BATCH_LINE = 8  # the member count the kernels line reports (a burst's eight clients)
# 16 l_shipdate literals: SERVE_DATES, then eight more
BATCH_DATES = SERVE_DATES + ("1992-03-10", "1992-11-11", "1993-07-07", "1994-04-01",
                             "1995-01-15", "1996-06-30", "1997-03-03", "1998-02-02")
# l_quantity > t: the serving burst's eight (5, 10, ..., 40), then eight more
QTY_LADDER = (5, 10, 15, 20, 25, 30, 35, 40, 2, 7, 12, 17, 22, 27, 32, 37)
SHIP_MODES = ("AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK")
LIBRARY_LADDER_ITERS = 3  # torch.bincount over a ladder's B members (ITERS, 20 after 3 warm-ups, before phase 17)
SERVE_BATCH_ROUNDS = 2  # rounds of each eight-literal burst per batching setting (6 before phase 16, 3 before 21)
_K1_BATCHED_ARGS = ("filter_fwd", "match", "num_docs", "value_fwds", "value_dicts", "capacity", "dtype",
                    "filter_bounds", "value_raws", "group_cols", "group_cards", "group_remaps")


def range_at(t: int) -> str:
    return RANGE.replace("l_quantity > 25", f"l_quantity > {t}")


def distinct_at(t: int) -> str:
    return VALUE_QUERIES["distinct_price"].replace("l_quantity > 25", f"l_quantity > {t}")


def hll_at(mode: str) -> str:
    return VALUE_QUERIES["hll_price"].replace("'AIR'", f"'{mode}'")


def _same(vals) -> bool:
    a = vals[0]
    if isinstance(a, torch.Tensor):
        return all(isinstance(v, torch.Tensor) and v.data_ptr() == a.data_ptr() and v.shape == a.shape
                   for v in vals)
    return all(v is a or v == a for v in vals)


def member_stack(members: List[dict]) -> Tuple[dict, List[str]]:
    """The batched call's arguments from its members' one-member
    arguments: a tensor every member shares (a staged stream or
    dictionary, one object) passes once, the tables each member's
    literals made stack on a leading member axis; also the names of the
    stacked ones."""
    out, stacked = {}, []
    for key, v0 in members[0].items():
        vals = [m[key] for m in members]
        if isinstance(v0, (list, tuple)):
            cols = []
            for j, col in enumerate(zip(*vals)):
                if col[0] is None or _same(col):
                    cols.append(col[0])
                else:
                    cols.append(torch.stack(col).contiguous())
                    stacked.append(f"{key}[{j}]")
            out[key] = cols
        elif isinstance(v0, torch.Tensor) and not _same(vals):
            out[key] = torch.stack(vals).contiguous()
            stacked.append(key)
        else:
            out[key] = v0
    return out, stacked


def member_rows(members: List[dict]) -> Tuple[List[int], int]:
    """(rows each member matches, rows any member matches), one segment
    at a time on the card."""
    a0 = members[0]
    lead = a0["values"] if "values" in a0 else a0["group_cols"][0]
    S, n = lead.shape
    rows = torch.arange(n, device=lead.device)
    matched, union = [0] * len(members), 0
    for s in range(S):
        hit = torch.zeros(n, dtype=torch.bool, device=lead.device)
        for i, a in enumerate(members):
            m = rows < a["num_docs"][s]
            f, b, mt = a.get("filter_fwd"), a.get("filter_bounds"), a.get("match")
            if mt is not None:
                fl = f[s].long()
                m &= (fl >= 0) & (fl < mt.shape[-1]) & mt[s].bool()[fl.clamp(0, mt.shape[-1] - 1)]
            elif f is not None:
                fi = f[s].int()
                m &= (fi >= b[s, 0]) & (fi < b[s, 1])
            elif b is not None:
                m &= (rows >= b[s, 0]) & (rows < b[s, 1])
            matched[i] += int(m.sum())
            hit |= m
        union += int(hit.sum())
    return matched, union


def batched_bound(kind: str, members: List[dict], stacked: List[str], vsc=None, mode: Optional[str] = None):
    """(bound ms, "bytes" or "operations", bytes, operations, rows any
    member matches, the members' own bytes summed) of one batched launch:
    it must read the filter stream of every row once, the other row
    streams of the rows any member matches once, the shared tables once
    and each member's own tables, and write each member's outputs; and do
    each member's operations (``k1_bound`` / ``k2_bound`` on its matched
    rows).  The last is what B one-member launches must move: a batched
    launch past that over the memory rate read some of it from L2."""
    matched, union = member_rows(members)
    a0 = members[0]
    if kind == "k1":
        rows0, nbytes0, per_row = k1_bytes(a0)
        ops = sum(k1_bound(a, m)[3] for a, m in zip(members, matched))
        solo_bytes = sum(k1_bound(a, m)[2] for a, m in zip(members, matched))
        fbytes = 8 if a0["dtype"] == torch.float64 else 4
        out = 8 + 8 * a0["capacity"] + fbytes * a0["capacity"] * len(a0["value_raws"])
    else:
        rows0, nbytes0, per_row = k2_bytes(vsc, mode, a0)
        ops = sum(k2_bound(vsc, mode, a, m)[3] for a, m in zip(members, matched))
        solo_bytes = sum(k2_bound(vsc, mode, a, m)[2] for a, m in zip(members, matched))
        K = vsc.index_space(mode, a0.get("capacity", 1), a0.get("width"))
        out = 8 + (8 * K if mode == "counts" else 4 * K if mode == "presence" else K // 64)
    fb = a0["filter_fwd"].element_size() if a0.get("filter_fwd") is not None else 0
    batched, _ = member_stack(members)
    own = 0
    for name in stacked:
        key, _, j = name.partition("[")
        t = batched[key][int(j[:-1])] if j else batched[key]
        own += t[0].numel() * t.element_size()
    nbytes = (rows0 if fb else 0) * fb + union * (per_row - fb) + (nbytes0 - rows0 * per_row) \
        + (len(members) - 1) * (own + out)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops, union, solo_bytes


def batched_probe(label: str, kind: str, members: List[dict], fg, vsc, mode: Optional[str] = None,
                  plain: bool = True) -> dict:
    """One ladder of B = BATCH_SIZES members: each member's one-member
    launch against its plain version (counts and holders exact, sums in
    the audit band), then at each B the batched launch, every member
    torch.equal to its one-member launch; per launch ms (CUDA events),
    per member, B one-member launches back to back, one one-member
    launch, and the batched launch's bound; at BATCH_LINE members also
    the batched plain version and, for K2, one torch.bincount over the
    members' combined indexes (each member's bins apart)."""
    if kind == "k1":
        solo = lambda a: fg.fused_filtered_groupby_sums(**a)  # noqa: E731

        def batch(args, B):
            return fg.fused_filtered_groupby_sums_batched(**{k: args[k] for k in _K1_BATCHED_ARGS}, members=B)

        def parts(out, m=None):
            docs, count, sums = out
            if m is None:
                return [docs, count, torch.stack(list(sums)) if len(sums) else count.new_zeros((0,))]
            return [docs[m], count[m], sums[m] if sums.shape[1] else count.new_zeros((0,))]
    else:
        solo = lambda a: vsc.value_state(mode, **a)  # noqa: E731
        batch = lambda args, B: vsc.value_state_batched(mode, **args, members=B)  # noqa: E731

        def parts(out, m=None):
            return list(out) if m is None else [out[0][m], out[1][m]]
    solos = [parts(solo(a)) for a in members]
    worst = 0.0
    if plain:
        for a, got in zip(members, solos):
            if kind == "k1":
                d, c, sm = fg.fused_filtered_groupby_sums_reference(**a)
                if int(d) != int(got[0]) or not torch.equal(c, got[1]):
                    raise AssertionError(f"{label}: a member's counts differ from the plain version")
                if len(sm):
                    worst = max(worst, _close(got[2], torch.stack(sm), AUDIT_RTOL, AUDIT_ATOL))
            else:
                d, h = vsc.value_state_reference(mode, **a)
                if int(d) != int(got[0]) or not torch.equal(h, got[1]):
                    raise AssertionError(f"{label}: a member's holder differs from the plain version")
    one_ms, _ = cuda_ms(lambda: solo(members[0]), ITERS)
    rec = {"one_member_ms": one_ms, "max_abs_err": worst, "by_B": {}}
    counter = fg if kind == "k1" else vsc
    for B in BATCH_SIZES:
        if B > len(members):
            break
        args, stacked = member_stack(members[:B])
        b0 = counter.batched_launches
        out = batch(args, B)
        torch.cuda.synchronize()
        if B > 1 and counter.batched_launches != b0 + 1:
            raise AssertionError(f"{label}: the batched launch was not counted")
        for m in range(B):
            if not all(torch.equal(x, y) for x, y in zip(parts(out, m), solos[m])):
                raise AssertionError(f"{label} B={B}: member {m} differs from its one-member launch")
        ms, _ = cuda_ms(lambda: batch(args, B), ITERS)
        solo_ms, _ = cuda_ms(lambda: [solo(a) for a in members[:B]], ITERS)
        bound, by, nbytes, ops, union, solo_bytes = batched_bound(kind, members[:B], stacked, vsc, mode)
        r = rec["by_B"][B] = dict(ms=ms, per_member_ms=ms / B, solo_total_ms=solo_ms, bound_ms=bound,
                                  bound_by=by, bytes=nbytes, operations=ops, union_rows=union, stacked=stacked,
                                  members_bytes=solo_bytes, members_tbps=solo_bytes / (ms / 1e3) / 1e12)
        if B == BATCH_LINE and plain:
            if kind == "k1":
                kw = {k: args[k] for k in _K1_BATCHED_ARGS}
                r["plain_ms"] = cuda_ms(lambda: fg.fused_filtered_groupby_sums_batched_reference(**kw, members=B),
                                        1, warmup=0)[0]
            else:
                r["plain_ms"] = cuda_ms(lambda: vsc.value_state_batched_reference(mode, **args, members=B),
                                        1, warmup=0)[0]
                idx, K = None, None
                parts_ = []
                for m, a in enumerate(members[:B]):
                    one, K, _ = vsc.combine_index(mode, **a)
                    parts_.append(one.reshape(-1) + m * (K + 1))  # int32: B * (K + 1) < 2^31
                idx = torch.cat(parts_)
                del parts_
                # hundreds of ms a call: LIBRARY_LADDER_ITERS, not ITERS
                r["library_ms"] = cuda_ms(lambda: torch.bincount(idx, minlength=B * (K + 1)),
                                          LIBRARY_LADDER_ITERS, warmup=1)[0]
                del idx
            log(f"{kind} batched {label} B={B}: plain version {r['plain_ms']:.4f} ms"
                + (f", torch.bincount over the members' combined indexes {r['library_ms']:.4f} ms"
                   if "library_ms" in r else ""))
        log(f"{kind} batched {label} B={B}: {ms:.4f} ms per launch, {ms / B:.4f} ms per member; {B} one-member "
            f"launches {solo_ms:.4f} ms ({solo_ms / ms:.3f}x the batched launch); one {one_ms:.4f} ms; bound "
            f"{bound:.4f} ms by {by} ({union} rows matched by any member, {nbytes} bytes, {ops} operations; "
            f"{bound / ms:.3f} of it); the members' own bytes {solo_bytes} at {r['members_tbps']:.3f} TB/s "
            f"({'above' if r['members_tbps'] * 1e12 > HBM_BYTES_PER_S else 'under'} the memory rate"
            f"{': some reads came from L2' if r['members_tbps'] * 1e12 > HBM_BYTES_PER_S else ''}); members' own "
            f"tables {stacked}; every member torch.equal to its one-member launch")
        del args, out
    log(f"{kind} batched {label}: every member's one-member launch equal to its plain version "
        f"(max_abs_err {worst:.6g})" if plain else f"{kind} batched {label}: plain versions not run")
    return rec


def k1_ladder_members(args: dict, dev) -> List[dict]:
    """Sixteen one-member K1 argument sets over one set of streams,
    differing in their filter's literals: a docrange's upper bound, or an
    interval's, as a date or threshold ladder makes them."""
    S, n = args["group_cols"][0].shape
    out = []
    for i in range(max(BATCH_SIZES)):
        b = args["filter_bounds"].clone()
        b[:, 1] = int(n * (i + 1) / (max(BATCH_SIZES) + 1))
        out.append(dict(args, filter_bounds=b.contiguous()))
    return out


def k2_ladder_members(mode: str, args: dict) -> List[dict]:
    """Sixteen one-member K2 argument sets over one set of streams: an
    interval's lower bound stepping (distinct_price's threshold ladder),
    or a one-entry match table stepping over the filter ids (hll_price's
    ship modes, repeating past seven)."""
    out = []
    for i in range(max(BATCH_SIZES)):
        if args.get("match") is not None:
            card = args["match"].shape[-1]
            mt = torch.zeros_like(args["match"])
            mt[:, i % min(card, 7)] = True
            out.append(dict(args, match=mt))
        else:
            b = args["filter_bounds"].clone()
            b[:, 0] = QTY_LADDER[i]
            out.append(dict(args, filter_bounds=b.contiguous()))
    return out


def range_oracles(segments, ts) -> Dict[int, dict]:
    """``oracle(segments, "range_unsorted")`` at each threshold of ``ts``,
    from one pass over the rows: counts and float64 sums by (group,
    l_quantity id), then summed over the ids above each threshold."""
    acc: Dict[int, dict] = {t: {} for t in ts}
    for seg in segments:
        q = seg.column("l_quantity")
        qv = np.asarray(q.dictionary.values, dtype=np.float64)
        rf, rfl = _labels(seg, "l_returnflag")
        keys = rf.astype(np.int64) * qv.size + q.fwd
        n = len(rfl) * qv.size
        cnt = np.bincount(keys, minlength=n).reshape(-1, qv.size)
        p = seg.column("l_extendedprice")
        price = np.asarray(p.dictionary.values, dtype=np.float64)[p.fwd]
        sums = np.bincount(keys, weights=price, minlength=n).reshape(-1, qv.size)
        for t in ts:
            ok = qv > t
            for i, lab in enumerate(rfl):
                c = int(cnt[i, ok].sum())
                if c:
                    e = acc[t].setdefault((lab,), {"count": 0, "sum_l_extendedprice": 0.0})
                    e["count"] += c
                    e["sum_l_extendedprice"] += float(sums[i, ok].sum())
    return acc


def distinct_oracles(segments, ts) -> Dict[int, Dict[Tuple[str, ...], int]]:
    """``value_oracle(.., "distinct_price")`` at each threshold of ``ts``:
    a price counts where the largest quantity of its rows passes the
    threshold (one bincount over (price id, quantity id) a segment)."""
    seen: Dict[int, list] = {t: [] for t in ts}
    for seg in segments:
        q, p = seg.column("l_quantity"), seg.column("l_extendedprice")
        qv = np.asarray(q.dictionary.values, dtype=np.float64)
        pv = np.asarray(p.dictionary.values, dtype=np.float64)
        occ = np.bincount(p.fwd.astype(np.int64) * qv.size + q.fwd, minlength=pv.size * qv.size)
        present = occ.reshape(pv.size, qv.size) > 0
        top = np.where(present.any(axis=1), qv.size - 1 - np.argmax(present[:, ::-1], axis=1), -1)
        top_q = np.where(top >= 0, qv[np.maximum(top, 0)], -np.inf)
        for t in ts:
            seen[t].append(pv[top_q > t])
    return {t: {(): int(np.unique(np.concatenate(v)).size)} for t, v in seen.items()}


# ---------------------------------------------------------------------------
# Exact host oracles of the value-state answers
# ---------------------------------------------------------------------------


def _present(column, rows=None) -> List[Any]:
    """Distinct values of a column over ``rows`` (all rows when None)."""
    fwd = column.fwd if rows is None else column.fwd[rows]
    seen = np.bincount(fwd, minlength=column.dictionary.cardinality) > 0
    return np.asarray(column.dictionary.values)[seen].tolist()


def _group_counts(seg, gcol: str, vcol: str, rows=None) -> Dict[Any, Tuple[np.ndarray, List[Any]]]:
    """{group value: (counts over vcol's dictionary, its values)}."""
    g, v = seg.column(gcol), seg.column(vcol)
    gf, vf = (g.fwd, v.fwd) if rows is None else (g.fwd[rows], v.fwd[rows])
    card = v.dictionary.cardinality
    cnt = np.bincount(gf.astype(np.int64) * card + vf, minlength=g.dictionary.cardinality * card)
    cnt = cnt.reshape(-1, card)
    return {g.dictionary.get(i): (cnt[i], list(v.dictionary.values)) for i in range(cnt.shape[0])}


def _rows_where(seg, col: str, pred) -> np.ndarray:
    c = seg.column(col)
    return np.array([pred(x) for x in c.dictionary.values], dtype=bool)[c.fwd]


def value_oracle(hll_mod, segments, name: str) -> Dict[Tuple[str, ...], Any]:
    """{group tuple (() when ungrouped): exact answer}: distinct counts from
    the set of matched values, percentiles as sorted[int(n p / 100)] over
    the matched values, HLL estimates from registers that the port's own
    hashing builds over the set of matched values."""
    if name in ("distinct_price", "hll_price", "zone_distinct"):
        seen = set()
        for seg in segments:
            if name == "zone_distinct":
                rows = _rows_where(seg, "l_shipdate", lambda v: v in ZONE_DATES)
            elif name == "distinct_price":
                q = seg.column("l_quantity")
                rows = (np.asarray(q.dictionary.values, dtype=np.float64) > 25)[q.fwd]
            else:
                rows = _rows_where(seg, "l_shipmode", lambda v: v == "AIR")
            seen.update(_present(seg.column("l_extendedprice"), rows))
        if name in ("distinct_price", "zone_distinct"):
            return {(): len(seen)}
        return {(): int(hll_mod.estimate_from_registers(hll_mod.registers_from_values(seen)))}
    if name == "hll_groupby":
        sets: Dict[Any, set] = {}
        for seg in segments:
            for label, (cnt, values) in _group_counts(seg, "l_returnflag", "l_shipdate").items():
                sets.setdefault(label, set()).update(v for v, c in zip(values, cnt) if c)
        return {
            (label,): int(hll_mod.estimate_from_registers(hll_mod.registers_from_values(vals)))
            for label, vals in sets.items() if vals
        }
    if name == "pct_quantity":
        hists: Dict[Any, Dict[float, int]] = {}
        for seg in segments:
            for label, (cnt, values) in _group_counts(seg, "l_shipmode", "l_quantity").items():
                h = hists.setdefault(label, {})
                for v, c in zip(values, cnt):
                    h[float(v)] = h.get(float(v), 0) + int(c)
        out = {}
        for label, h in hists.items():
            vals = sorted(v for v, c in h.items() if c)
            cum = np.cumsum([h[v] for v in vals])
            if vals:
                idx = min(int(cum[-1] * 90 / 100.0), int(cum[-1]) - 1)
                out[(label,)] = vals[int(np.searchsorted(cum, idx, side="right"))]
        return out
    raise ValueError(name)


def north_star_oracle(hll_mod, segments) -> Dict[Tuple[str, ...], int]:
    """Per campaign, HLL registers over the users of its rows (the port's
    per-dictionary hash tables, max rank per register), then estimates."""
    m = hll_mod.M
    present = None
    for seg in segments:
        camp = seg.column("campaign_id")
        user = seg.column("user_id")
        cvals = np.asarray(camp.dictionary.values, dtype=np.int64)
        bt, rt = hll_mod.dictionary_tables(user.dictionary)
        ncamp = int(cvals.max()) + 1
        key = (cvals[camp.fwd] * m + bt[user.fwd]) * 64 + rt[user.fwd]
        hit = np.bincount(key, minlength=ncamp * m * 64) > 0
        present = hit if present is None else present | hit
    regs = (present.reshape(-1, m, 64) * np.arange(64)).max(axis=2).astype(np.uint8)
    ests = hll_mod.estimate_from_registers(regs)
    rows = present.reshape(-1, m * 64).any(axis=1)
    return {(str(c),): int(ests[c]) for c in np.nonzero(rows)[0]}


def _column_values(column, docs) -> list:
    vals = column.dictionary.values
    return [vals[int(i)] for i in column.fwd[docs]]


def selection_oracle(segments, name: str) -> Tuple[List[str], List[list]]:
    """(columns, rows) of a selection picked on the host: every matched
    row ordered by its sort values, ties by segment and doc, then the
    OFFSET / LIMIT window."""
    seg0 = segments[0]
    if name == "sel_first":
        cols, rows = ["l_shipmode", "l_extendedprice"], []
        for seg in segments:
            mode = seg.column("l_shipmode")
            docs = np.nonzero(mode.fwd == mode.dictionary.index_of("AIR"))[0][: 10 - len(rows)]
            rows += [list(r) for r in zip(*(_column_values(seg.column(c), docs) for c in cols))]
            if len(rows) == 10:
                return cols, rows
        return cols, rows
    cands = []
    if name == "sel_top":
        cols, window = ["l_shipdate", "l_extendedprice", "l_quantity"], (0, 10)
        for si, seg in enumerate(segments):
            q, p = seg.column("l_quantity"), seg.column("l_extendedprice")
            docs = np.nonzero((np.asarray(q.dictionary.values) > 45)[q.fwd])[0]
            price = np.asarray(p.dictionary.values)[p.fwd[docs]]
            keep = price >= np.partition(price, price.size - 10)[price.size - 10]
            cands += [((-v,), si, d) for v, d in zip(price[keep], docs[keep])]
    elif name == "sel_wide":
        cols, window = list(seg0.columns), (5, 15)
        for si, seg in enumerate(segments):
            p = seg.column("l_extendedprice")
            price = np.asarray(p.dictionary.values)[p.fwd]
            docs = np.nonzero(price <= np.partition(price, 14)[14])[0]
            ship = _column_values(seg.column("l_shipdate"), docs)
            recv = _column_values(seg.column("l_receiptdate"), docs)
            cands += [((price[d], a, b), si, d) for d, a, b in zip(docs, ship, recv)]
    else:
        raise ValueError(name)
    cands.sort()
    rows = []
    for _, si, d in cands[window[0] : window[1]]:
        seg = segments[si]
        rows.append([_column_values(seg.column(c), [d])[0] for c in cols])
    return cols, rows


def _global_ids(columns) -> Tuple[np.ndarray, List[np.ndarray]]:
    """(sorted union of the columns' dictionary values, per column the
    global id of each of its dictionary entries)."""
    union = np.unique(np.concatenate([np.asarray(c.dictionary.values) for c in columns]))
    return union, [np.searchsorted(union, np.asarray(c.dictionary.values)) for c in columns]


def pair_oracle(hll_mod, segments, name: str) -> Tuple[Dict[Tuple[str, ...], Any], int, int]:
    """({group tuple: exact answer}, unique (group, value) pairs, matched
    rows) of a pair query, from the host segments: distinct counts and
    percentiles over the matched (group, value) pairs, HLL estimates from
    registers of the matched users' (bucket, rho), the port's own hashing."""
    if name in ("pairs_pct", "pairs_distinct"):
        dates, date_ids = _global_ids([s.column("l_shipdate") for s in segments])
        prices, price_ids = _global_ids([s.column("l_extendedprice") for s in segments])
        keys = []
        for seg, di, pi in zip(segments, date_ids, price_ids):
            q = seg.column("l_quantity")
            rows = (np.asarray(q.dictionary.values) == 1.0)[q.fwd]
            keys.append(di[seg.column("l_shipdate").fwd[rows]] * prices.size
                        + pi[seg.column("l_extendedprice").fwd[rows]])
        keys = np.sort(np.concatenate(keys))
        uniq = np.unique(keys)
        if name == "pairs_distinct":
            counts = np.bincount(uniq // prices.size, minlength=dates.size)
            want = {(str(dates[g]),): int(c) for g, c in enumerate(counts) if c}
        else:
            n = np.bincount(keys // prices.size, minlength=dates.size)
            start = np.concatenate([[0], np.cumsum(n)[:-1]])
            want = {}
            for g in np.nonzero(n)[0]:
                idx = min(int(n[g] * 90 / 100.0), int(n[g]) - 1)
                want[(str(dates[g]),)] = float(prices[keys[start[g] + idx] % prices.size])
        return want, int(uniq.size), int(keys.size)
    if name in ("reach_exact", "reach_hll_site", "reach_overflow"):
        keys = []
        sites = 32 if name == "reach_overflow" else 8
        # a tile shares its base segment's columns (tile_segments): its pairs
        # are its base's, so each base is keyed once and its rows counted
        # once a tile
        tiles: Dict[Tuple[int, ...], int] = {}
        bases = []
        for seg in segments:
            ident = tuple(id(seg.column(c)) for c in ("campaign_id", "site_id", "user_id"))
            if ident not in tiles:
                bases.append(seg)
            tiles[ident] = tiles.get(ident, 0) + 1
        matched = 0
        for seg in bases:
            camp, site, user = seg.column("campaign_id"), seg.column("site_id"), seg.column("user_id")
            svals = np.asarray(site.dictionary.values, dtype=np.int64)
            rows = (svals < sites)[site.fwd]
            c = np.asarray(camp.dictionary.values, dtype=np.int64)[camp.fwd[rows]]
            if name != "reach_hll_site":
                keys.append(c * (1 << 40) + np.asarray(user.dictionary.values)[user.fwd[rows]])
            else:
                bt, rt = hll_mod.dictionary_tables(user.dictionary)
                group = c * 8 + svals[site.fwd[rows]]
                keys.append((group * hll_mod.M + bt[user.fwd[rows]]) * 64 + rt[user.fwd[rows]])
            matched += keys[-1].size * tiles[tuple(id(seg.column(c_)) for c_ in ("campaign_id", "site_id", "user_id"))]
        uniq = np.unique(np.concatenate(keys))
        if name != "reach_hll_site":
            counts = np.bincount(uniq >> 40)
            return {(str(g),): int(c) for g, c in enumerate(counts) if c}, int(uniq.size), matched
        regs = np.zeros(AD_CAMPAIGNS * 8 * hll_mod.M, dtype=np.uint8)
        np.maximum.at(regs, uniq >> 6, (uniq & 63).astype(np.uint8))
        present = np.zeros(AD_CAMPAIGNS * 8, dtype=bool)
        present[(uniq >> 6) // hll_mod.M] = True
        ests = hll_mod.estimate_from_registers(regs.reshape(-1, hll_mod.M))
        want = {(str(g // 8), str(g % 8)): int(ests[g]) for g in np.nonzero(present)[0]}
        return want, int(uniq.size), matched
    raise ValueError(name)


def served_distinct_oracle(covers: List[list], top_n: int = 10) -> Dict[Tuple[str, ...], int]:
    """pairs_distinct as the broker answers it over servers that each trim
    their candidate groups first (``results.trim_group_candidates``, the
    reference's per-server topN*5 trim, MCombineGroupByOperator.java:216):
    a server keeps the groups whose local distinct count reaches its
    max(5 top_n, 100)-th largest, and a group's answer is the size of the
    union of the value sets of the servers that kept it."""
    segments = [s for cover in covers for s in cover]
    dates, date_ids = _global_ids([s.column("l_shipdate") for s in segments])
    prices, price_ids = _global_ids([s.column("l_extendedprice") for s in segments])
    trim = max(top_n * 5, 100)
    kept, i = [], 0
    for cover in covers:
        keys = []
        for seg in cover:
            q = seg.column("l_quantity")
            rows = (np.asarray(q.dictionary.values) == 1.0)[q.fwd]
            keys.append(date_ids[i][seg.column("l_shipdate").fwd[rows]] * prices.size
                        + price_ids[i][seg.column("l_extendedprice").fwd[rows]])
            i += 1
        uniq = np.unique(np.concatenate(keys))
        counts = np.bincount(uniq // prices.size, minlength=dates.size)
        present = counts[counts > 0]
        boundary = np.sort(present)[-trim] if present.size > trim else 1
        kept.append(uniq[counts[uniq // prices.size] >= boundary])
    counts = np.bincount(np.unique(np.concatenate(kept)) // prices.size, minlength=dates.size)
    return {(str(dates[g]),): int(c) for g, c in enumerate(counts) if c}


def check_value_response(resp, want: Dict[Tuple[str, ...], Any], top_n: int = 10) -> None:
    """The one aggregation's answer equals the oracle exactly: the value
    when ungrouped, else the top_n groups in the broker's order (value
    descending, then group key) with their values."""
    (ar,) = resp.aggregation_results
    if ar.group_by_result is None:
        if ar.value != want[()]:
            raise AssertionError(f"{ar.function}: {ar.value} != oracle {want[()]}")
        return
    got = [(tuple(g.group), g.value) for g in ar.group_by_result]
    exp = sorted(want.items(), key=lambda kv: (-kv[1], kv[0]))[:top_n]
    if got != exp:
        raise AssertionError(f"{ar.function}: {got} != oracle {exp}")


def check_top(ar, want: Dict[Tuple[str, ...], float], exact: bool, top_n: int = 10) -> float:
    """One grouped aggregation against its oracle: the top_n groups in the
    broker's order (value descending, then group key).  ``exact``: groups
    and values equal.  Else (float sums) each returned value within the
    audit band of its oracle value, and each returned group's oracle value
    no lower than the top_n-th less the band (near-ties may swap).
    Returns the largest relative error."""
    got = [(tuple(g.group), float(g.value)) for g in ar.group_by_result]
    exp = sorted(want.items(), key=lambda kv: (-kv[1], kv[0]))[:top_n]
    if exact:
        if got != [(k, float(v)) for k, v in exp]:
            raise AssertionError(f"{ar.function}: {got} != oracle {exp}")
        return 0.0
    if len(got) != len(exp):
        raise AssertionError(f"{ar.function}: {len(got)} groups, oracle {len(exp)}")
    nth = exp[-1][1]
    worst = 0.0
    for key, v in got:
        w = want.get(key)
        if w is None or not math.isclose(v, w, rel_tol=AUDIT_RTOL, abs_tol=AUDIT_ATOL):
            raise AssertionError(f"{ar.function} {key}: {v} vs oracle {w}")
        if w < nth - (AUDIT_ATOL + AUDIT_RTOL * abs(nth)):
            raise AssertionError(f"{ar.function} {key}: oracle {w} is below the top {top_n} ({nth})")
        worst = max(worst, abs(v - w) / max(abs(w), 1e-30))
    return worst


def host_groups_oracle(segments):
    """(sum of l_extendedprice, count) per (l_shipdate, l_receiptdate) over
    the rows with l_quantity > 45, in float64 from the host segments: two
    arrays over the key space of the sorted unions of the two dictionaries
    (key k is (ship[k // len(receipt)], receipt[k % len(receipt)]), so key
    order is label order), summed segment by segment, and the two label
    lists."""
    ship = sorted(set().union(*(seg.column("l_shipdate").dictionary.values for seg in segments)))
    receipt = sorted(set().union(*(seg.column("l_receiptdate").dictionary.values for seg in segments)))
    n = len(ship) * len(receipt)
    sums, counts = np.zeros(n), np.zeros(n)
    for seg in segments:
        q, p = seg.column("l_quantity"), seg.column("l_extendedprice")
        rows = (np.asarray(q.dictionary.values, dtype=np.float64) > 45)[q.fwd]
        sd, rd = seg.column("l_shipdate"), seg.column("l_receiptdate")
        sd_ids = np.searchsorted(np.asarray(ship), np.asarray(sd.dictionary.values))[sd.fwd[rows]]
        rd_ids = np.searchsorted(np.asarray(receipt), np.asarray(rd.dictionary.values))[rd.fwd[rows]]
        keys = sd_ids.astype(np.int64) * len(receipt) + rd_ids
        counts += np.bincount(keys, minlength=n)
        sums += np.bincount(keys, weights=np.asarray(p.dictionary.values, dtype=np.float64)[p.fwd[rows]],
                            minlength=n)
    return sums, counts, ship, receipt


def host_groups_want(ar, values, counts, ship, receipt, top_n: int = 10) -> Dict[Tuple[str, ...], float]:
    """The part of ``host_groups_oracle``'s answer that ``check_top`` reads:
    the top_n groups in the broker's order (value descending, then key) and
    every group ``ar`` returned, so ``check_top`` over it checks what it
    would over all of the groups."""
    present = np.nonzero(counts)[0]
    top = present[np.lexsort((present, -values[present]))][:top_n]
    want = {(ship[k // len(receipt)], receipt[k % len(receipt)]): float(values[k]) for k in top.tolist()}
    for g in ar.group_by_result:
        a, b = g.group
        i, j = bisect.bisect_left(ship, a), bisect.bisect_left(receipt, b)
        if i < len(ship) and ship[i] == a and j < len(receipt) and receipt[j] == b and counts[i * len(receipt) + j]:
            want[(a, b)] = float(values[i * len(receipt) + j])
    return want


def _mv_entries(column) -> Tuple[np.ndarray, np.ndarray]:
    """(row of each entry, dictId of each entry) of an MV column's CSR."""
    counts = np.diff(column.mv_offsets)
    return np.repeat(np.arange(counts.size), counts), column.mv_values


def mv_query_values(segments) -> Dict[str, Any]:
    """The pool values the MV queries filter on, picked from segment 0's
    dictionaries at fixed positions."""
    ints = segments[0].column("dimIntMV").dictionary
    strs = segments[0].column("dimStrMV").dictionary
    n, m = ints.cardinality, strs.cardinality
    return {"i0": ints.get(n // 10), "i1": ints.get(n // 2), "i2": ints.get(9 * n // 10),
            "s0": strs.get(m // 3), "s1": strs.get(2 * m // 3)}


def mv_oracle(hll_mod, distinct, copies: int, name: str, values: Dict[str, Any]):
    """Exact (counts, distinct sets, percentiles, HLL) or float64 (sums)
    answers of an MV query over the CSR arrays of the ``distinct``
    segments, each tiled ``copies`` times: {display name: {group tuple
    (() ungrouped): value}}."""
    out: Dict[str, Dict[Tuple[str, ...], Any]] = {}

    def add(fn, key, v):
        d = out.setdefault(fn, {})
        d[key] = d.get(key, 0) + v

    if name == "mv_aggs":
        seen_i, seen_s, hist = set(), set(), {}
        total, n = 0.0, 0
        for seg in distinct:
            c = seg.column("dimIntMV")
            vals = np.asarray(c.dictionary.values, dtype=np.int64)
            cnt = np.bincount(c.mv_values, minlength=vals.size)
            total += float((cnt * vals).sum())
            n += int(cnt.sum())
            seen_i.update(vals[cnt > 0].tolist())
            for v, k in zip(vals, cnt):
                hist[int(v)] = hist.get(int(v), 0) + int(k) * copies
            s = seg.column("dimStrMV")
            seen_s.update(np.asarray(s.dictionary.values, dtype=object)[
                np.bincount(s.mv_values, minlength=s.dictionary.cardinality) > 0].tolist())
        vs = sorted(v for v, k in hist.items() if k)
        cum = np.cumsum([hist[v] for v in vs])
        idx = min(int(cum[-1] * 90 / 100.0), int(cum[-1]) - 1)
        return {"summv_dimIntMV": {(): total * copies}, "countmv_dimIntMV": {(): float(n * copies)},
                "distinctcountmv_dimIntMV": {(): len(seen_i)},
                "percentile90mv_dimIntMV": {(): float(vs[int(np.searchsorted(cum, idx, side="right"))])},
                "distinctcounthllmv_dimStrMV": {(): int(hll_mod.estimate_from_registers(
                    hll_mod.registers_from_values(seen_s)))}}
    for seg in distinct:
        if name == "mv_filter":
            c = seg.column("dimIntMV")
            rows_e, ids = _mv_entries(c)
            hit_ids = np.isin(np.asarray(c.dictionary.values), [values["i0"], values["i1"], values["i2"]])
            rows = np.zeros(seg.num_docs, dtype=bool)
            rows[rows_e[hit_ids[ids]]] = True
            g, labels = _labels(seg, "dimStr")
            met = np.asarray(seg.column("metDouble").dictionary.values, dtype=np.float64)[
                seg.column("metDouble").fwd]
            cnt = np.bincount(g[rows], minlength=len(labels))
            tot = np.bincount(g[rows], weights=met[rows], minlength=len(labels))
            for k in np.nonzero(cnt)[0]:
                add("sum_metDouble", (labels[k],), float(tot[k]) * copies)
                add("count_star", (labels[k],), float(cnt[k]) * copies)
        elif name == "mv_not":
            c = seg.column("dimStrMV")
            rows_e, ids = _mv_entries(c)
            out_ids = np.isin(np.asarray(c.dictionary.values, dtype=object), [values["s0"], values["s1"]])
            excluded = np.zeros(seg.num_docs, dtype=bool)
            excluded[rows_e[out_ids[ids]]] = True
            rows = ~excluded
            met = seg.column("metInt")
            add("count_star", (), float(rows.sum()) * copies)
            mx = float(np.asarray(met.dictionary.values)[met.fwd[rows]].max())
            out["max_metInt"] = {(): max(out.get("max_metInt", {}).get((), -math.inf), mx)}
        elif name in ("mv_groupby", "mv_grouped_state"):
            break  # over the global key space below
        else:
            raise ValueError(name)
    if name not in ("mv_groupby", "mv_grouped_state"):
        return out
    # the group labels as ids into the sorted unions of the segments'
    # dictionaries (key order is label order), summed segment by segment
    mv_col = "dimStrMV" if name == "mv_groupby" else "dimIntMV"
    labels, label_ids = _global_ids([seg.column("dimStr") for seg in distinct])
    if name == "mv_grouped_state":  # distinct (label, value) pairs over every segment
        values_g, value_ids = _global_ids([seg.column(mv_col) for seg in distinct])
        pairs = []
        for seg, li, vi in zip(distinct, label_ids, value_ids):
            rows_e, ids = _mv_entries(seg.column(mv_col))
            pairs.append(li[seg.column("dimStr").fwd[rows_e]].astype(np.int64) * values_g.size + vi[ids])
        uniq = np.unique(np.concatenate(pairs))
        per_label = np.bincount(uniq // values_g.size, minlength=labels.size)
        return {"distinctcountmv_dimIntMV": {(str(labels[k]),): int(per_label[k]) for k in np.nonzero(per_label)[0]}}
    mlabels, mlabel_ids = _global_ids([seg.column(mv_col) for seg in distinct])
    n = mlabels.size * labels.size
    cnt_all, tot_all = np.zeros(n), np.zeros(n)
    for seg, li, mi in zip(distinct, label_ids, mlabel_ids):
        rows_e, ids = _mv_entries(seg.column(mv_col))
        keys = mi[ids].astype(np.int64) * labels.size + li[seg.column("dimStr").fwd[rows_e]]
        met = np.asarray(seg.column("metFloat").dictionary.values, dtype=np.float64)[seg.column("metFloat").fwd]
        cnt_all += np.bincount(keys, minlength=n) * float(copies)
        tot_all += np.bincount(keys, weights=met[rows_e], minlength=n) * copies
    present = np.nonzero(cnt_all)[0]
    keys = [(str(mlabels[k // labels.size]), str(labels[k % labels.size])) for k in present.tolist()]
    return {"sum_metFloat": dict(zip(keys, tot_all[present].tolist())),
            "count_star": dict(zip(keys, cnt_all[present].tolist()))}


def check_mv_response(resp, want) -> float:
    """Every aggregation of an MV query against ``mv_oracle``'s answer:
    counts, maxima, distinct counts, percentiles and HLL estimates exact,
    float sums within the audit band.  Returns the largest relative sum
    error."""
    worst = 0.0
    for ar in resp.aggregation_results:
        exact = not ar.function.startswith("sum")
        w = want[ar.function]
        if ar.group_by_result is not None:
            worst = max(worst, check_top(ar, w, exact))
            continue
        v, wv = float(ar.value), float(w[()])
        if exact and v != wv:
            raise AssertionError(f"{ar.function}: {v} != oracle {wv}")
        if not math.isclose(v, wv, rel_tol=AUDIT_RTOL, abs_tol=AUDIT_ATOL):
            raise AssertionError(f"{ar.function}: {v} vs oracle {wv}")
        worst = max(worst, abs(v - wv) / max(abs(wv), 1e-30))
    return worst


def partials_of(result) -> list:
    """Every group's partials as plain values, for a bit-for-bit compare."""
    return [(k, [sorted(vars(p).items()) for p in ps]) for k, ps in sorted(result.groups.items())]


def profile_query(fn, name: str, runs: int = 5) -> dict:
    """Trace ``runs`` calls with torch.profiler: device time per kernel
    name (summed over the runs), the host wall time of the window, and
    the device's busy share of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_kernel = {}
    for ev in prof.key_averages():
        # device-side events only (kernels, copies, memsets): a CPU op's
        # self device time repeats the time of the kernels it launched
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us > 0:
            by_kernel[ev.key] = float(us)
    busy_us = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    log(f"profile {name}: {runs} runs, wall {wall_us / runs / 1e3:.4f} ms per query, device busy "
        f"{busy_us / runs / 1e3:.4f} ms per query ({busy_us / wall_us:.3f} of wall)")
    for k, us in top:
        log(f"  {us / runs / 1e3:9.4f} ms/query  {k[:100]}")
    return {"runs": runs, "wall_ms_per_query": wall_us / runs / 1e3,
            "device_busy_ms_per_query": busy_us / runs / 1e3, "busy_share": busy_us / wall_us,
            "device_ms_per_query_by_kernel": {k: us / runs / 1e3 for k, us in by_kernel.items()}}


def _capture(module, name: str, into: dict, key: str):
    """Replace module.name by a wrapper that records its arguments in
    ``into[key]``; returns the function to restore."""
    real = getattr(module, name)

    def wrapper(*a, **k):
        into[key] = (a, k)
        return real(*a, **k)

    setattr(module, name, wrapper)
    return real


class CountingTransport:
    """A transport that records the DataTable bytes of every reply."""

    def __init__(self, inner) -> None:
        self.inner = inner
        self.reply_bytes: List[int] = []
        self._lock = threading.Lock()

    def request(self, address, payload: bytes, timeout: float = 15.0) -> bytes:
        reply = self.inner.request(address, payload, timeout=timeout)
        with self._lock:
            self.reply_bytes.append(len(reply))
        return reply


def q1_at(date: str) -> str:
    return Q1.replace("'1998-09-02'", f"'{date}'")


def q1_oracles(segments, dates) -> Dict[str, dict]:
    """``oracle(segments, "q1")`` at each l_shipdate literal in ``dates``,
    from one pass over the rows: the counts and float64 sums by (group,
    l_shipdate id), then summed over the ids at or below each date."""
    acc: Dict[str, dict] = {d: {} for d in dates}
    sums_of = ("l_quantity", "l_extendedprice", "l_discount")
    for seg in segments:
        ship = seg.column("l_shipdate")
        card = len(ship.dictionary.values)
        rf, rfl = _labels(seg, "l_returnflag")
        ls, lsl = _labels(seg, "l_linestatus")
        keys = (rf.astype(np.int64) * len(lsl) + ls) * card + ship.fwd
        n = len(rfl) * len(lsl) * card
        cnt = np.bincount(keys, minlength=n).reshape(-1, card)
        sums = {}
        for col in sums_of:
            c = seg.column(col)
            v = np.asarray(c.dictionary.values, dtype=np.float64)[c.fwd]
            sums[f"sum_{col}"] = np.bincount(keys, weights=v, minlength=n).reshape(-1, card)
        labels = [(a, b) for a in rfl for b in lsl]
        for d in dates:
            ok = np.array([v <= d for v in ship.dictionary.values])
            for i, lab in enumerate(labels):
                c_ = int(cnt[i, ok].sum())
                if not c_:
                    continue
                e = acc[d].setdefault(lab, {"count": 0, **{k: 0.0 for k in sums}})
                e["count"] += c_
                for k in sums:
                    e[k] += float(sums[k][i, ok].sum())
    return acc


def check_served(name: str, resp, want) -> None:
    """A broker reply of the serving phase against the same oracle as the
    in-process run: counts, distinct, HLL and selection exact, sums in the
    audit band, served by the device (no segmentsHost)."""
    if resp.exceptions:
        raise AssertionError(f"serve {name}: {[e.to_json() for e in resp.exceptions]}")
    if resp.cost.get("segmentsHost"):
        raise AssertionError(f"serve {name}: served by the host tier, cost {resp.cost}")
    if name in QUERIES:
        check_response(resp, want)
    elif name in VALUE_QUERIES:
        check_value_response(resp, want)
    elif name in SELECTION_QUERIES:
        cols, rows = want
        got = resp.selection_results
        if got.columns != cols or got.rows != rows:
            raise AssertionError(f"serve {name}: {got.columns} {got.rows} != oracle {cols} {rows}")
    else:  # pairs_distinct: the oracle of the servers' trim (served_distinct_oracle)
        check_value_response(resp, want)


class _Fleet:
    """Port servers on ``dev``, each on a TcpServer on localhost, behind a
    port broker whose transport counts the reply bytes."""

    def __init__(self, dev, cover: Dict[str, list], table: str = "lineitem", **server_kw) -> None:
        from pinot_tpu_torch.broker.broker import BrokerRequestHandler
        from pinot_tpu_torch.broker.routing import RoutingTableProvider
        from pinot_tpu_torch.server.instance import ServerInstance
        from pinot_tpu_torch.transport.tcp import TcpServer, TcpTransport

        self.servers, self.tcp = {}, {}
        for name in cover:
            server = self.servers[name] = ServerInstance(name, device=dev, precision="x32", **server_kw)
            self.tcp[name] = TcpServer(server.handle_request)
            self.tcp[name].start()
        self.routing = RoutingTableProvider()
        self.add_table(table, cover)
        self.transport = CountingTransport(TcpTransport())
        self.broker = BrokerRequestHandler(self.transport, {n: t.address for n, t in self.tcp.items()},
                                           routing=self.routing, timeout_ms=600_000)

    def add_table(self, table: str, cover: Dict[str, list]) -> None:
        """Each server's segments of ``table``, routed ONLINE."""
        for name, segs in cover.items():
            for seg in segs:
                self.servers[name].add_segment(table, seg)
        self.routing.update(table, {s.segment_name: {n: "ONLINE"} for n, segs in cover.items() for s in segs})

    def timers(self, name: str, last: int) -> List[float]:
        """The last ``last`` samples of a server phase timer, every server."""
        out = []
        for server in self.servers.values():
            out += server.metrics.timer(name).samples()[-last:]
        return out

    def close(self) -> None:
        self.broker.shutdown()
        for t in self.tcp.values():
            t.stop()
        for server in self.servers.values():
            server.shutdown()


def burst(broker, pqls: List[str]) -> list:
    """Send ``pqls`` at once, one client thread each."""
    out: List[Any] = [None] * len(pqls)
    errors: List[BaseException] = []
    gate = threading.Barrier(len(pqls))

    def client(i: int) -> None:
        try:
            gate.wait()
            out[i] = broker.handle_pql(pqls[i])
        except BaseException as e:  # noqa: BLE001 - re-raised on the main thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(pqls))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def batch_bursts(fleet, ladders: Dict[str, Tuple[List[str], List[Any], Any]], label: str) -> dict:
    """The eight-literal bursts of one batching setting through ``fleet``:
    per ladder (name: (pqls, oracles, checker)) SERVE_BATCH_ROUNDS rounds of
    eight clients at once, every answer against its own oracle and none
    from the host tier; the broker's p50 / p99 over the rounds, the lanes'
    batchLaunches / batchedQueries, the replies' batchHits and the members
    that took the block path, after one untimed burst; then one held
    round, the lanes held until every member has queued (the batch the
    tier forms under a backlog)."""
    out = {}
    for name, (pqls, oracles, check) in ladders.items():
        # one untimed burst first: a ladder's first queries on a server
        # stage its columns (hundreds of ms), which is not burst latency
        burst(fleet.broker, pqls)
        before = [s.lane.stats() for s in fleet.servers.values()]
        broker_ms, hits, block = [], 0, set()
        for _ in range(SERVE_BATCH_ROUNDS):
            replies = burst(fleet.broker, pqls)
            for i, (resp, want) in enumerate(zip(replies, oracles)):
                if resp.exceptions or resp.cost.get("segmentsHost"):
                    raise AssertionError(f"serve {label} {name}[{i}]: {resp.exceptions} {resp.cost}")
                check(resp, want)
                broker_ms.append(resp.time_used_ms)
                hits += int(resp.cost.get("batchHits", 0))
                if resp.cost.get("segmentsZonemap"):
                    block.add(i)
        after = [s.lane.stats() for s in fleet.servers.values()]
        launches = sum(a["batchLaunches"] - b["batchLaunches"] for a, b in zip(after, before))
        queries = sum(a["batchedQueries"] - b["batchedQueries"] for a, b in zip(after, before))
        # one held round: each lane busy until all eight queued
        gate = threading.Event()
        for srv in fleet.servers.values():
            srv.lane.submit(("hold", name, time.monotonic()), lambda: gate.wait(60))
        held = []
        t = threading.Thread(target=lambda: held.extend(burst(fleet.broker, pqls)))
        t.start()
        time.sleep(1.0)
        gate.set()
        t.join()
        held_hits = 0
        for i, (resp, want) in enumerate(zip(held, oracles)):
            if resp.exceptions or resp.cost.get("segmentsHost"):
                raise AssertionError(f"serve {label} {name} held [{i}]: {resp.exceptions} {resp.cost}")
            check(resp, want)
            held_hits += int(resp.cost.get("batchHits", 0))
        final = [s.lane.stats() for s in fleet.servers.values()]
        r = out[name] = dict(
            p50_ms=float(np.percentile(broker_ms, 50)), p99_ms=float(np.percentile(broker_ms, 99)),
            samples=len(broker_ms), batch_launches=launches, batched_queries=queries, batch_hits=hits,
            block_path_members=sorted(block),
            held_batch_launches=sum(f["batchLaunches"] - a["batchLaunches"] for f, a in zip(final, after)),
            held_batch_hits=held_hits)
        log(f"serve {label} {name}: broker p50 {r['p50_ms']:.3f} ms, p99 {r['p99_ms']:.3f} ms over "
            f"{len(broker_ms)} replies ({SERVE_BATCH_ROUNDS} rounds of {len(pqls)} clients at once); lanes "
            f"batchLaunches {launches}, batchedQueries {queries}; replies' batchHits {hits}; members on the "
            f"block path {sorted(block)}; held round: batchLaunches {r['held_batch_launches']}, batchHits "
            f"{held_hits}; every answer equal to its own oracle")
    return out


def serve_phase(dev, segments, wants, record, fg, vsc) -> None:
    """9. The same queries through two servers and the broker over TCP,
    then concurrency, the batching tier's bursts with and without it,
    then failover on a reduced table."""
    from pinot_tpu_torch.common.faults import DeviceFaultInjector
    from pinot_tpu_torch.engine import config
    from pinot_tpu_torch.tools.datagen import synthetic_lineitem_segment

    pqls = {**QUERIES, **VALUE_QUERIES, **SELECTION_QUERIES, **PAIR_QUERIES}
    # the distinct-literal bursts' oracles, in a thread beside the first steps
    qtys = QTY_LADDER[:len(SERVE_DATES)]
    literal_pool = concurrent.futures.ThreadPoolExecutor(1)
    literal_wants = literal_pool.submit(lambda: (q1_oracles(segments, SERVE_DATES), range_oracles(segments, qtys),
                                                 distinct_oracles(segments, qtys)))
    literal_pool.shutdown(wait=False)
    half = len(segments) // 2
    covers = {"server0": segments[:half], "server1": segments[half:]}
    # every oracle as in the in-process phases, but pairs_distinct's: each
    # server trims its 2000 groups to its own top 100 before the broker
    # merges them, so the served answer is that of the trim
    wants = dict(wants)
    exact, _, _ = wants["pairs_distinct"]
    wants["pairs_distinct"] = served_distinct_oracle(list(covers.values()))
    top = lambda w: sorted(w.items(), key=lambda kv: (-kv[1], kv[0]))[:10]  # noqa: E731
    differ = [g for (g, v), (h, u) in zip(top(wants["pairs_distinct"]), top(exact)) if (g, v) != (h, u)]
    log(f"serve pairs_distinct: the trimmed oracle's top 10 differs from the exact one in {len(differ)} "
        f"places {top(wants['pairs_distinct'])[:3]} vs {top(exact)[:3]}")
    fleet = _Fleet(dev, covers)
    rec = record["serving"] = {"queries": {}, "pairs_distinct_top10_differs_from_exact": len(differ)}
    try:
        # the path: one request per query, every launch count 0 just before
        fg.launches = 0
        vsc.launches = 0
        per_query = {}
        t = time.perf_counter()
        need = {"q1": ("k1",), "q3": ("k1",), "hll_groupby": ("k2",), "distinct_price": ("k2",),
                "pairs_distinct": ("k1",)}
        for name in SERVE_QUERIES:
            k1_before, k2_before = fg.launches, vsc.launches
            check_served(name, fleet.broker.handle_pql(pqls[name]), wants[name])
            per_query[name] = {"k1": fg.launches - k1_before, "k2": vsc.launches - k2_before}
            for kern in need.get(name, ()):
                if per_query[name][kern] < 1:
                    raise AssertionError(f"serve {name}: kernel {kern} was not launched")
        torch.cuda.synchronize()
        totals = {"k1": fg.launches, "k2": vsc.launches}
        wall_s = time.perf_counter() - t
        record["paths"]["serving"] = {"launches": per_query, "totals": totals, "wall_s": wall_s}
        staged = sum(s.executor.staged_bytes() for s in fleet.servers.values())
        peak = max(record["staged_bytes_by_table"].values())
        log(f"path serving (staging included): {wall_s:.1f} s, launches per query {per_query}, total "
            f"{totals}; every answer equal to its oracle through 2 servers and the broker over TCP; staged "
            f"on the card {staged} bytes over both servers (the direct executors' peak {peak})")
        if staged > peak:
            raise AssertionError(f"serving staged {staged} bytes, past the earlier peak {peak}")
        rec.update(staged_bytes=staged, launches=per_query, totals=totals)

        # broker-side latency over SERVE_ITERS requests after warm-up, the
        # servers' split and the DataTable bytes of each reply
        for name in SERVE_QUERIES:
            for _ in range(SERVE_WARMUP):
                check_served(name, fleet.broker.handle_pql(pqls[name]), wants[name])
            fleet.transport.reply_bytes.clear()
            broker_ms, client_ms = [], []
            for _ in range(SERVE_ITERS):
                t = time.perf_counter()
                resp = fleet.broker.handle_pql(pqls[name])
                client_ms.append((time.perf_counter() - t) * 1e3)
                broker_ms.append(resp.time_used_ms)
                if resp.exceptions or resp.cost.get("segmentsHost"):
                    raise AssertionError(f"serve {name}: {resp.exceptions} {resp.cost}")
            check_served(name, resp, wants[name])
            split = {k: float(np.median(fleet.timers(f"phase.{k}", SERVE_ITERS)))
                     for k in ("schedulerWait", "tierDecision", "staging", "planBuild", "laneWait", "planExec",
                               "finalize")}
            dt_bytes = sorted(fleet.transport.reply_bytes)
            q = dict(p50_ms=float(np.percentile(broker_ms, 50)), p99_ms=float(np.percentile(broker_ms, 99)),
                     client_p50_ms=float(np.percentile(client_ms, 50)), server_ms=split,
                     datatable_bytes_per_reply=float(np.median(dt_bytes)), replies=len(dt_bytes),
                     direct_ms=record["query_ms"].get(name))
            rec["queries"][name] = q
            log(f"serve {name}: broker p50 {q['p50_ms']:.3f} ms, p99 {q['p99_ms']:.3f} ms over {SERVE_ITERS} "
                f"(client p50 {q['client_p50_ms']:.3f}; in-process median {q['direct_ms']:.3f}); server medians "
                f"{ {k: round(v, 4) for k, v in split.items()} } ms; DataTable {q['datatable_bytes_per_reply']:.0f} "
                f"bytes per reply (median of {len(dt_bytes)})")

        # concurrency: 8 clients send the same q1 at once; the answers are
        # byte-identical and the lanes coalesce identical dispatches
        hits0 = sum(s.lane.coalesce_hits for s in fleet.servers.values())
        bursts = 0
        for bursts in range(1, SERVE_BURSTS + 1):
            out = burst(fleet.broker, [Q1] * SERVE_CLIENTS)
            answers = {json.dumps([a.to_json() for a in r.aggregation_results]) for r in out}
            if len(answers) != 1 or any(r.exceptions or r.cost.get("segmentsHost") for r in out):
                raise AssertionError(f"serve concurrent q1: {len(answers)} distinct answers")
            check_response(out[0], wants["q1"])
            hits = sum(s.lane.coalesce_hits for s in fleet.servers.values()) - hits0
            if hits > 0:
                break
        if hits <= 0:
            raise AssertionError(f"serve concurrent q1: no coalesced dispatch in {bursts} bursts")
        log(f"serve concurrent q1: {SERVE_CLIENTS} clients at once, answers byte-identical, lane.coalesced "
            f"{hits} over the two servers after {bursts} burst(s)")
        rec["coalesced"] = {"hits": hits, "bursts": bursts, "clients": SERVE_CLIENTS}

        # 8 clients at once, each with its own l_shipdate literal, each held
        # to its own oracle (stream and allocator races show here)
        t = time.perf_counter()
        want_at, want_range, want_distinct = literal_wants.result()
        log(f"serve distinct q1, range and distinct_price oracles: {len(SERVE_DATES)} literals each, waited "
            f"{time.perf_counter() - t:.1f} s for their thread")
        worst = 0.0
        for _ in range(SERVE_DISTINCT_ROUNDS):
            out = burst(fleet.broker, [q1_at(d) for d in SERVE_DATES])
            for d, resp in zip(SERVE_DATES, out):
                if resp.exceptions or resp.cost.get("segmentsHost"):
                    raise AssertionError(f"serve q1 <= {d}: {resp.exceptions} {resp.cost}")
                worst = max(worst, check_response(resp, want_at[d]))
        log(f"serve concurrent distinct q1: {SERVE_DISTINCT_ROUNDS} rounds of {len(SERVE_DATES)} clients at "
            f"once, each equal to its own oracle (max rel sum err {worst:.3g})")
        rec["distinct"] = {"rounds": SERVE_DISTINCT_ROUNDS, "clients": len(SERVE_DATES), "max_rel_err": worst}

        # the micro-batching tier: three eight-literal bursts at the
        # defaults (BATCH_MAX, BATCH_WINDOW_MS); the batched kernels'
        # launch counts 0 just before, read just after
        ladders = {
            "q1_dates": ([q1_at(d) for d in SERVE_DATES], [want_at[d] for d in SERVE_DATES], check_response),
            "range_qty": ([range_at(t) for t in qtys], [want_range[t] for t in qtys], check_response),
            "distinct_price_qty": ([distinct_at(t) for t in qtys], [want_distinct[t] for t in qtys],
                                   check_value_response),
        }
        fg.batched_launches = 0
        vsc.batched_launches = 0
        t = time.perf_counter()
        rec["batching"] = {"defaults": batch_bursts(fleet, ladders, "batched")}
        torch.cuda.synchronize()
        totals = {"k1_batched": fg.batched_launches, "k2_batched": vsc.batched_launches}
        record["batched_paths"] = {"serving": {"totals": totals, "wall_s": time.perf_counter() - t}}
        log(f"path serving_batched: batched launches {totals} over the three bursts at BATCH_MAX "
            f"{config.BATCH_MAX}, BATCH_WINDOW_MS {config.BATCH_WINDOW_MS}")
        for kern, n in totals.items():
            if n < 1:
                raise AssertionError(f"serve: the batched kernel {kern} was not launched by the bursts")
        rec["lanes"] = {n: s.lane.stats() for n, s in fleet.servers.items()}
        rec["heal"] = {n: s.executor.healing_stats() for n, s in fleet.servers.items()}
        if any(h["hostFailovers"] or h["deviceFailures"] for h in rec["heal"].values()):
            raise AssertionError(f"serve: a device error in the serving phase {rec['heal']}")
        # phase 18 (a): the serving planes on these servers, lineitem staged
        planes_phase(dev, fleet, segments, wants, record, fg, vsc)
    finally:
        fleet.close()
    for server in fleet.servers.values():
        server.executor.free_staging()
    del fleet
    torch.cuda.empty_cache()

    # the same bursts with the tier off (config.BATCH_MAX = 1; the lanes
    # read it when they are made)
    batch_max, config.BATCH_MAX = config.BATCH_MAX, 1
    try:
        fleet = _Fleet(dev, covers)
        try:
            for pql in (Q1, RANGE, VALUE_QUERIES["distinct_price"]):  # staging and first launches
                fleet.broker.handle_pql(pql)
            rec["batching"]["batch_max_1"] = batch_bursts(fleet, ladders, "unbatched")
            if any(s.lane.stats()["batchLaunches"] for s in fleet.servers.values()):
                raise AssertionError("serve: a batch formed with BATCH_MAX = 1")
        finally:
            fleet.close()
            for server in fleet.servers.values():
                server.executor.free_staging()
            del fleet
            torch.cuda.empty_cache()
    finally:
        config.BATCH_MAX = batch_max

    # q1 through one server that holds all the segments: one server a
    # process, as a deployment runs it (the two servers above share one
    # interpreter, and their lane threads its lock)
    fleet = _Fleet(dev, {"server0": segments})
    server = fleet.servers["server0"]
    try:
        for _ in range(SERVE_WARMUP):
            check_served("q1", fleet.broker.handle_pql(pqls["q1"]), wants["q1"])
        broker_ms = []
        for _ in range(SERVE_ITERS):
            resp = fleet.broker.handle_pql(pqls["q1"])
            broker_ms.append(resp.time_used_ms)
            if resp.exceptions or resp.cost.get("segmentsHost"):
                raise AssertionError(f"serve one server q1: {resp.exceptions} {resp.cost}")
        check_served("q1", resp, wants["q1"])
        heal = server.executor.healing_stats()
        if heal["hostFailovers"] or heal["deviceFailures"]:
            raise AssertionError(f"serve one server: a device error {heal}")
        split = {k: float(np.median(fleet.timers(f"phase.{k}", SERVE_ITERS)))
                 for k in ("schedulerWait", "tierDecision", "planBuild", "laneWait", "laneDispatch", "planExec",
                           "finalize")}
        one = rec["one_server"] = dict(p50_ms=float(np.percentile(broker_ms, 50)),
                                       p99_ms=float(np.percentile(broker_ms, 99)), server_ms=split)
        log(f"serve one server q1 (all {len(segments)} segments): broker p50 {one['p50_ms']:.3f} ms, p99 "
            f"{one['p99_ms']:.3f} ms over {SERVE_ITERS}; server medians "
            f"{ {k: round(v, 4) for k, v in split.items()} } ms")
    finally:
        fleet.close()
        server.executor.free_staging()
        del fleet, server
        torch.cuda.empty_cache()

    # failover on a reduced table, through one server with a fault injector
    small = [synthetic_lineitem_segment(FAILOVER_ROWS, seed=101 + i, name=f"fo{i}")
             for i in range(FAILOVER_SEGMENTS)]
    want = oracle(small, "q1")
    inj = DeviceFaultInjector()
    fleet = _Fleet(dev, {"failover": small}, lane_stall_timeout_s=FAILOVER_STALL_TIMEOUT_S,
                   device_fault_injector=inj)
    server = fleet.servers["failover"]
    rec["failover"] = {}

    def ask(label: str, host: bool) -> None:
        t = time.perf_counter()
        resp = fleet.broker.handle_pql(Q1)
        wall = (time.perf_counter() - t) * 1e3
        if resp.exceptions:
            raise AssertionError(f"failover {label}: {[e.to_json() for e in resp.exceptions]}")
        check_response(resp, want)
        if bool(resp.cost.get("segmentsHost")) != host:
            raise AssertionError(f"failover {label}: served by the wrong tier, cost {resp.cost}")
        heal = server.executor.healing_stats()
        rec["failover"][label] = {"ms": wall, "broker_ms": resp.time_used_ms, "cost": dict(resp.cost),
                                  "heal": heal, "restarts": server.lane.restart_count}
        log(f"failover {label}: {wall:.3f} ms, oracle ok, tier {'host' if host else 'device'}, "
            f"segmentsHost {resp.cost.get('segmentsHost', 0)}, heal {heal}, lane restarts "
            f"{server.lane.restart_count}")

    try:
        ask("warm", host=False)
        inj.fail_next(1, retryable=True)
        ask("transient", host=False)
        if server.executor.healing_stats()["deviceRetries"] != 1:
            raise AssertionError("failover transient: no device retry")
        inj.poison_plan(inj.launches[-1].digest)
        ask("poison", host=True)
        if server.executor.healing_stats()["hostFailovers"] != 1:
            raise AssertionError("failover poison: hostFailovers not marked")
        inj.heal()
        server.executor.clear_poisoned()
        ask("healed", host=False)
        inj.stall_next(1, FAILOVER_STALL_S)
        ask("stall", host=True)
        if server.lane.restart_count != 1:
            raise AssertionError("failover stall: the lane did not restart")
        time.sleep(FAILOVER_STALL_S)  # the wedged launch returns and is discarded
    finally:
        fleet.close()
        server.executor.free_staging()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 18. the serving planes: (a) on phase 9's two servers, (b) in phase 14's
# realtime table, (c) on phase 17's deployed roles
# ---------------------------------------------------------------------------

PLANES_QUERIES = ("q1", "q3", "hll_groupby", "distinct_price")  # the result cache's queries
PLANES_ITERS = 10  # broker requests of the hit and the miss p50s
# requests at each auditor setting: each server's count is primed, so the
# default 1-in-64 audits the first one a server (64 before phase 21)
PLANES_AUDIT_ITERS = 32
# the auditor's cost on serving: q1's and pairs_distinct's oracles are numpy
# (seconds at full width); the host tier runs sel_top's (every matched row)
# and distinct_price's (no vectorized path) row by row (minutes)
PLANES_AUDIT_COST_QUERIES = ("q1", "sel_top", "pairs_distinct", "distinct_price")
PLANES_AUDIT_DEFAULT_N = 64  # the shadow auditor's default sample rate (PINOT_TPU_AUDIT_SAMPLE_N)
PLANES_CAP = 2  # the lineitem table's in-flight cap for the admission burst
PLANES_BURST = 8  # concurrent q1s of the burst
PLANES_ADMIT_STALL_S = 0.5  # the admitted queries' launch stall, so the burst overlaps them
PLANES_REP_SEGMENTS = 2  # the reduced table, on both servers
PLANES_REP_ROWS = 1 << 20
PLANES_HEDGE_MS = 50.0  # hedge_delay_ms of the reduced table's broker
PLANES_STALL_S = 2.0  # the stalled primary's launch
PLANES_WAIT_S = 600.0  # for a background audit
# the reference's top-level keys of each /debug surface (pinot_tpu/broker/broker.py:1386-1442,
# pinot_tpu/server/network_starter.py:113-151)
PLANES_BROKER_KEYS = {
    "admission": {"maxInflightPerTable", "serverWindows", "tableInflight"},
    "history": {"capacity", "intervalS", "samples", "series"},
    "slo": {"burningTables", "config", "tables", "worstBurning"},
    "tails": {"byDigest", "capacity", "enabled", "entries", "observed", "retained", "sampleN", "slowMs"},
    "queries": {"capacity", "entries", "thresholdMs", "totalQueries", "totalRecorded"},
    "flightrec": {"bundles", "dir", "dumps", "enabled", "maxBundles", "minIntervalS"},
    "audit": {"freshness", "replica"},
}
PLANES_SERVER_KEYS = {
    "history": PLANES_BROKER_KEYS["history"],
    "audit": {"budgetPerS", "divergences", "dropped", "enabled", "errors", "offered", "quarantined", "queueDepth",
              "recentDivergences", "sampleN", "samples"},
    "flightrec": PLANES_BROKER_KEYS["flightrec"],
}
PLANES_SLO = {"latencyMs": 250.0, "latencyTarget": 0.95}  # the slo block of phase 17's extra table


def _reply(resp) -> str:
    """A broker reply without its wall clock, request id and cost: what a
    cache hit must repeat byte for byte."""
    return json.dumps({k: v for k, v in resp.to_json().items() if k not in ("timeUsedMs", "requestId", "cost")},
                      sort_keys=True)


def _wait_for(label: str, pred, timeout_s: float = PLANES_WAIT_S) -> float:
    """Seconds until ``pred()`` holds; raises past ``timeout_s``."""
    t = time.perf_counter()
    end = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() > end:
            raise AssertionError(f"planes: {label} not within {timeout_s} s")
        time.sleep(0.02)
    return time.perf_counter() - t


def planes_phase(dev, fleet, segments, wants, record, fg, vsc) -> None:
    """18 (a). On phase 9's two servers while they hold lineitem staged:
    the result cache (a miss launches K1 / K2, its hit launches nothing and
    repeats its bytes, EXPLAIN's cacheHit, hit against miss p50, a
    re-staged segment misses), the shadow audit at full width (q1 and
    hll_groupby on the host oracle over all 134,217,728 rows, each
    "equivalent"; the p50 of q1, sel_top, pairs_distinct and
    distinct_price with the default 1-in-64 auditor against it off, each
    oracle in a forked child), an admission burst past an in-flight cap; then on a reduced table
    replicated on both servers: a hedge around a stalled launch, a wrong
    answer injected on the device tier caught, quarantined and healed, and
    the replica audit."""
    import dataclasses

    from pinot_tpu_torch.broker.broker import BrokerHttpServer, BrokerRequestHandler
    from pinot_tpu_torch.broker.routing import RoutingTableProvider
    from pinot_tpu_torch.common.faults import DeviceFaultInjector
    from pinot_tpu_torch.common.response import ErrorCode
    from pinot_tpu_torch.engine.plandigest import plan_shape_digest
    from pinot_tpu_torch.engine.rescache import ResultCache
    from pinot_tpu_torch.pql import optimize_request, parse_pql
    from pinot_tpu_torch.segment.immutable import new_staging_token
    from pinot_tpu_torch.tools.datagen import synthetic_lineitem_segment
    from pinot_tpu_torch.transport.tcp import TcpTransport
    from pinot_tpu_torch.utils.audit import ReplicaAuditor, SamplerBudget, ShadowAuditor

    rec = record["planes"] = {"card": card_line()}
    t_phase = time.perf_counter()
    pqls = {**QUERIES, **VALUE_QUERIES, **SELECTION_QUERIES, **PAIR_QUERIES}
    servers, broker = fleet.servers, fleet.broker
    # the phase's path: every launch count 0 just before, read at its end
    fg.launches = vsc.launches = fg.batched_launches = vsc.batched_launches = 0
    rows = sum(s.num_docs for s in segments)

    def launched() -> Dict[str, int]:
        return {"k1": fg.launches + fg.batched_launches, "k2": vsc.launches + vsc.batched_launches,
                "dispatches": sum(s.lane.dispatch_count for s in servers.values())}

    # (1) the result cache, on for the phase: each miss launches, each hit
    # launches nothing and repeats the miss's bytes; one reply a server
    saved_caches = {n: s.result_cache for n, s in servers.items()}
    for s in servers.values():
        s.result_cache = ResultCache(metrics=s.metrics, enabled=True)
    cache = rec["cache"] = {"queries": {}}
    try:
        saved = {"k1": 0, "k2": 0}
        for name in PLANES_QUERIES:
            before = launched()
            miss = broker.handle_pql(pqls[name])
            mid = launched()
            hit = broker.handle_pql(pqls[name])
            after = launched()
            check_served(name, miss, wants[name])
            kern = "k1" if name in QUERIES else "k2"
            if "rescacheHits" in miss.cost or mid[kern] - before[kern] < 1:
                raise AssertionError(f"planes cache {name}: the miss launched {mid} from {before}, cost {miss.cost}")
            if after != mid or hit.cost != {"rescacheHits": len(servers)}:
                raise AssertionError(f"planes cache {name}: the hit launched {after} from {mid}, cost {hit.cost}")
            if _reply(hit) != _reply(miss):
                raise AssertionError(f"planes cache {name}: the hit's bytes differ from the miss's")
            for k in saved:
                saved[k] += mid[k] - before[k]
            cache["queries"][name] = {"miss_launches": {k: mid[k] - before[k] for k in mid},
                                      "miss_ms": miss.time_used_ms, "hit_ms": hit.time_used_ms}
        plan = broker.handle_pql("EXPLAIN " + Q1)
        flags = [n["device"]["batching"]["cacheHit"] for n in plan.explain["servers"]]
        if flags != [True] * len(servers):
            raise AssertionError(f"planes cache: EXPLAIN's cacheHit {flags} with the entries standing")
        hit_ms, miss_ms = [], []
        for _ in range(PLANES_ITERS):
            r = broker.handle_pql(Q1)
            if r.cost != {"rescacheHits": len(servers)}:
                raise AssertionError(f"planes cache: a hit's cost {r.cost}")
            hit_ms.append(r.time_used_ms)
        for _ in range(PLANES_ITERS):
            for s in servers.values():
                s.result_cache.clear()
            r = broker.handle_pql(Q1)
            if "rescacheHits" in r.cost:
                raise AssertionError(f"planes cache: a miss's cost {r.cost}")
            miss_ms.append(r.time_used_ms)
        check_served("q1", r, wants["q1"])
        broker.handle_pql(Q1)  # the entry stands again
        # one segment re-staged: a new staging token, so the next q1 misses
        name0 = next(iter(servers))
        tdm = servers[name0].data_manager.table("lineitem")
        held = tdm.acquire_segments()
        old = held[0].segment
        tdm.release_segments(held)
        servers[name0].add_segment("lineitem", dataclasses.replace(old, staging_token=new_staging_token()))
        before = launched()
        t = time.perf_counter()
        r = broker.handle_pql(Q1)
        restage_ms = (time.perf_counter() - t) * 1e3
        got = {k: v - before[k] for k, v in launched().items()}
        check_served("q1", r, wants["q1"])
        # the re-staged server misses and launches; the other's entry stands
        if r.cost.get("rescacheHits", 0) != len(servers) - 1 or got["k1"] < 1:
            raise AssertionError(f"planes cache: the re-staged q1 launched {got}, cost {r.cost}")
        cache.update(hit_p50_ms=float(np.percentile(hit_ms, 50)), miss_p50_ms=float(np.percentile(miss_ms, 50)),
                     launches_saved=dict(saved), restaged_q1_ms=restage_ms, restaged_launches=got,
                     stats={n: s.result_cache.snapshot() for n, s in servers.items()})
        log(f"planes cache: q1, q3, hll_groupby and distinct_price twice each: every miss equal to its oracle and "
            f"launching K1 / K2, every hit byte-identical with cost rescacheHits 1 a server's reply and no launch "
            f"(launches saved {saved}); EXPLAIN cacheHit {flags}; q1 broker p50 hit {cache['hit_p50_ms']:.3f} ms "
            f"against miss {cache['miss_p50_ms']:.3f} ms over {PLANES_ITERS}; after a re-staged segment q1 missed on "
            f"its server (the other's entry hit), launched {got} in {restage_ms:.1f} ms")
    finally:
        for n, s in servers.items():
            s.result_cache = saved_caches[n]

    # (2) the shadow audit at full width: 1-in-1 for q1 and hll_groupby,
    # each server's host oracle over its 8 segments
    audit = rec["audit"] = {}
    saved_auditors = {n: s.auditor for n, s in servers.items()}
    try:
        for n, s in servers.items():
            s.auditor = ShadowAuditor(s, sample_n=1, budget=SamplerBudget(per_s=1000.0))
        for name in ("q1", "hll_groupby"):
            samples0 = {n: s.metrics.meter("audit.samples").count for n, s in servers.items()}
            div0 = {n: s.metrics.meter("audit.divergences").count for n, s in servers.items()}
            t = time.perf_counter()
            check_served(name, broker.handle_pql(pqls[name]), wants[name])
            _wait_for(f"the {name} audit", lambda: all(
                s.metrics.meter("audit.samples").count > samples0[n] for n, s in servers.items()))
            wall_s = time.perf_counter() - t
            div = {n: s.metrics.meter("audit.divergences").count - div0[n] for n, s in servers.items()}
            if any(div.values()):
                raise AssertionError(f"planes audit {name}: a divergence at full width {div}")
            shadow = {n: s.metrics.timer("audit.shadowMs").samples()[-1] for n, s in servers.items()}
            audit[name] = {"verdict": "equivalent", "rows": rows, "shadow_ms": shadow, "wall_s": wall_s}
            log(f"planes audit {name}: 1-in-1, equivalent on both servers, the host oracle over {rows} rows "
                f"{ {n: round(v, 1) for n, v in shadow.items()} } ms a server (8 segments each, in parallel), "
                f"{wall_s:.1f} s from the request to both verdicts")
    finally:
        for n, s in servers.items():
            s.auditor.stop()
            s.auditor = saved_auditors[n]
    # the serving p50 with the default auditor against it off: each
    # server's next offer sampled, so one forked oracle a server runs beside
    # the requests; a child still running after them is stopped (killed)
    cost = audit["cost"] = {}
    try:
        for name in PLANES_AUDIT_COST_QUERIES:
            cost[name] = {}
            for label, n_ in (("default", PLANES_AUDIT_DEFAULT_N), ("off", 0)):
                for n, s in servers.items():
                    s.auditor = ShadowAuditor(s, sample_n=n_)
                    s.auditor._count = n_ - 1 if n_ else 0
                samples0 = {n: s.metrics.meter("audit.samples").count for n, s in servers.items()}
                forks0 = {n: len(s.metrics.timer("audit.forkMs").samples()) for n, s in servers.items()}
                ms = []
                for _ in range(PLANES_AUDIT_ITERS):
                    r = broker.handle_pql(pqls[name])
                    ms.append(r.time_used_ms)
                check_served(name, r, wants[name])
                if n_:  # each server's oracle forked (a row-by-row one runs on for minutes)
                    _wait_for(f"the {name} oracles' forks", lambda: all(
                        len(s.metrics.timer("audit.forkMs").samples()) > forks0[n] for n, s in servers.items()))
                fork_ms = {n: s.metrics.timer("audit.forkMs").samples()[forks0[n]:] for n, s in servers.items()}
                if any(len(v) != (1 if n_ else 0) for v in fork_ms.values()):
                    raise AssertionError(f"planes audit cost {name}: forks {fork_ms} at 1-in-{n_}")
                cost[name][label] = {
                    "sample_n": n_, "p50_ms": float(np.percentile(ms, 50)), "p99_ms": float(np.percentile(ms, 99)),
                    "fork_ms": fork_ms,
                    "audits_done": {n: s.metrics.meter("audit.samples").count - samples0[n]
                                    for n, s in servers.items()}}
                for s in servers.values():
                    s.auditor.stop()
            d, o = cost[name]["default"], cost[name]["off"]
            log(f"planes audit cost {name}: broker p50 {d['p50_ms']:.3f} ms (p99 {d['p99_ms']:.3f}) with the "
                f"default 1-in-{d['sample_n']} auditor against {o['p50_ms']:.3f} ms (p99 {o['p99_ms']:.3f}) off, "
                f"over {PLANES_AUDIT_ITERS} requests each; the oracle in a forked child, fork "
                f"{ {n: [round(x, 1) for x in v] for n, v in d['fork_ms'].items()} } ms, audits done in the "
                f"window {d['audits_done']}")
    finally:
        for n, s in servers.items():
            s.auditor.stop()
            s.auditor = saved_auditors[n]

    # (3) admission: an in-flight cap of 2 and a burst of 8 q1s; the
    # admitted queries' first launch a server is stalled, so they overlap
    adm = broker.admission
    cap0 = adm.max_inflight_per_table
    injectors = {n: DeviceFaultInjector() for n in servers}
    http = BrokerHttpServer(broker)
    http.start()
    try:
        for n, s in servers.items():
            s.lane.fault_injector = injectors[n]
            injectors[n].stall_next(1, PLANES_ADMIT_STALL_S)
        adm.max_inflight_per_table = PLANES_CAP
        shed0 = broker.metrics.meter("admission.shedConcurrency").count
        dropped0 = broker.metrics.meter("queriesDropped").count
        out = burst(broker, [Q1] * PLANES_BURST)
        admitted = [r for r in out if not r.exceptions]
        shed = [r for r in out if r.exceptions]
        for r in shed:
            codes = [e.error_code for e in r.exceptions]
            if codes != [ErrorCode.TOO_MANY_REQUESTS] or "in flight" not in r.exceptions[0].message:
                raise AssertionError(f"planes admission: a shed reply {[e.to_json() for e in r.exceptions]}")
        for r in admitted:
            check_served("q1", r, wants["q1"])
        snap = http_json(http.url + "/debug/admission")
        counted = {"shedConcurrency": broker.metrics.meter("admission.shedConcurrency").count - shed0,
                   "queriesDropped": broker.metrics.meter("queriesDropped").count - dropped0}
        if not admitted or not shed or counted != {"shedConcurrency": len(shed), "queriesDropped": len(shed)}:
            raise AssertionError(f"planes admission: {len(admitted)} admitted, {len(shed)} shed, counters {counted}")
        if snap["maxInflightPerTable"] != PLANES_CAP or snap["tableInflight"] or any(
                w["inflight"] for w in snap["serverWindows"].values()):
            raise AssertionError(f"planes admission: /debug/admission {snap}")
        rec["admission"] = {"sent": PLANES_BURST, "admitted": len(admitted), "shed": len(shed), "counters": counted,
                            "debug": snap}
        log(f"planes admission: in-flight cap {PLANES_CAP}, a burst of {PLANES_BURST} q1s: {len(admitted)} admitted "
            f"and equal to the oracle, {len(shed)} shed with 429; /debug/admission {snap}; counters {counted}")
    finally:
        adm.max_inflight_per_table = cap0
        http.stop()

    # (4) a reduced table replicated on both servers, behind a broker that
    # hedges after PLANES_HEDGE_MS and routes each segment the same way
    table = "lineitem_rep"
    q1r = Q1.replace("FROM lineitem", f"FROM {table}")
    small = [synthetic_lineitem_segment(PLANES_REP_ROWS, seed=201 + i, name=f"rep{i}")
             for i in range(PLANES_REP_SEGMENTS)]
    want = oracle(small, "q1")
    for s in servers.values():
        for seg in small:
            s.add_segment(table, seg)
    addresses = {n: t.address for n, t in fleet.tcp.items()}
    routing = RoutingTableProvider(num_tables=1)
    routing.update(table, {seg.segment_name: {n: "ONLINE" for n in servers} for seg in small})
    hb = BrokerRequestHandler(TcpTransport(), addresses, routing=routing, timeout_ms=600_000,
                              hedge_delay_ms=PLANES_HEDGE_MS)
    s0 = servers[next(iter(servers))]
    cb = None
    aud0, frec0 = s0.auditor, s0.flightrec.dir
    frec_dir = tempfile.mkdtemp(prefix="pinot-flightrec-")
    try:
        for _ in range(3):
            r = hb.handle_pql(q1r)
            check_served("q1", r, want)
        base_ms = [hb.handle_pql(q1r).time_used_ms for _ in range(5)]
        cover = routing.find_servers(table)
        stalled = sorted(cover)[0]
        other = next(n for n in servers if n != stalled)
        ok0 = len(injectors[other].records_for("ok"))
        injectors[stalled].stall_next(1, PLANES_STALL_S)
        t = time.perf_counter()
        r = hb.handle_pql(q1r)
        hedged_ms = (time.perf_counter() - t) * 1e3
        check_served("q1", r, want)
        if r.num_hedges != 1 or len(injectors[other].records_for("ok")) <= ok0:
            raise AssertionError(f"planes hedge: numHedges {r.num_hedges}, launches on {other} "
                                 f"{len(injectors[other].records_for('ok')) - ok0}")
        time.sleep(PLANES_STALL_S)  # the losing launch runs to its end; its reply is dropped
        rec["hedge"] = {"cover": {n: list(v) for n, v in cover.items()}, "stalled": stalled, "answered_by": other,
                        "hedged_ms": hedged_ms, "broker_ms": r.time_used_ms, "stall_ms": PLANES_STALL_S * 1e3,
                        "hedge_delay_ms": PLANES_HEDGE_MS, "base_p50_ms": float(np.percentile(base_ms, 50)),
                        "num_hedges": r.num_hedges}
        log(f"planes hedge: {table} ({PLANES_REP_SEGMENTS} x {PLANES_REP_ROWS} rows on both servers), {stalled}'s "
            f"launch stalled {PLANES_STALL_S} s, the hedge after {PLANES_HEDGE_MS} ms answered from {other}'s lane "
            f"(K1 launched there) in {hedged_ms:.1f} ms, equal to the oracle, numHedges 1 (unhedged p50 "
            f"{rec['hedge']['base_p50_ms']:.3f} ms)")

        # the replica audit: one query, the primary and the other replica
        hb.replica_audit.stop()
        hb.replica_audit = ReplicaAuditor(hb, sample_n=1, budget=SamplerBudget(per_s=1000.0))
        before = launched()
        check_served("q1", hb.handle_pql(q1r), want)
        _wait_for("the replica audit", lambda: hb.replica_audit.snapshot()["checks"] >= 1)
        rep = hb.replica_audit.snapshot()
        if rep["divergences"]:
            raise AssertionError(f"planes replica audit: {rep}")
        rec["replica_audit"] = {"checks": rep["checks"], "divergences": rep["divergences"],
                                "launches": {k: v - before[k] for k, v in launched().items()}}
        log(f"planes replica audit: 1-in-1 on q1, {rep['checks']} check(s), the two lanes agree "
            f"(launches {rec['replica_audit']['launches']})")
        # a wrong answer on the device tier of q1's digest, caught by the
        # shadow audit, quarantined, healed by the host tier
        crouting = RoutingTableProvider(num_tables=1)
        crouting.update(table, {seg.segment_name: {s0.name: "ONLINE"} for seg in small})
        cb = BrokerRequestHandler(TcpTransport(), {s0.name: addresses[s0.name]}, routing=crouting,
                                  timeout_ms=600_000)
        s0.auditor = ShadowAuditor(s0, sample_n=1, budget=SamplerBudget(per_s=1000.0))
        s0.flightrec.dir = frec_dir
        digest = plan_shape_digest(optimize_request(parse_pql(q1r)))
        samples0 = s0.metrics.meter("audit.samples").count
        check_served("q1", cb.handle_pql(q1r), want)
        _wait_for("the honest audit", lambda: s0.metrics.meter("audit.samples").count > samples0)
        div0 = s0.metrics.meter("audit.divergences").count
        if div0 != 0:
            raise AssertionError(f"planes corruption: {div0} divergence(s) before any injection")
        injectors[s0.name].corrupt_results(1, tier="device", digest_substring=digest, delta=1e6)
        lied = cb.handle_pql(q1r)
        if lied.exceptions:
            raise AssertionError(f"planes corruption: {lied.exceptions}")
        try:
            check_response(lied, want)
        except AssertionError:
            pass
        else:
            raise AssertionError("planes corruption: the injected answer equals the oracle")
        t = time.perf_counter()
        detect_s = _wait_for("the divergence", lambda: s0.metrics.meter("audit.divergences").count >= 1)
        quarantined = s0.audit_snapshot()["quarantined"]
        if s0.metrics.meter("audit.divergences").count != 1 or [(q["planDigest"], q["tier"]) for q in quarantined] \
                != [(digest, "device")]:
            raise AssertionError(f"planes corruption: divergences {s0.metrics.meter('audit.divergences').count}, "
                                 f"quarantined {quarantined}")
        healed = cb.handle_pql(q1r)
        if healed.exceptions or not healed.cost.get("segmentsHost"):
            raise AssertionError(f"planes corruption: the next q1 {healed.exceptions} cost {healed.cost}")
        check_response(healed, want)
        bundles = [json.load(open(os.path.join(frec_dir, f))) for f in sorted(os.listdir(frec_dir))
                   if f.endswith(".json")]
        div = [b for b in bundles if b["reason"] == "auditDivergence"]
        if not div or not {"producedPayload", "expectedPayload"} <= set(div[0]["detail"]):
            raise AssertionError(f"planes corruption: bundles {[b['reason'] for b in bundles]}")
        s0.executor.clear_poisoned()
        rec["corruption"] = {"digest": digest, "divergences": 1, "quarantined": quarantined,
                             "detect_s": detect_s, "healed_cost": dict(healed.cost),
                             "bundle_reasons": [b["reason"] for b in bundles]}
        log(f"planes corruption: corrupt_results on the device tier of q1's digest {digest}: served (nothing "
            f"raised), audit.divergences 1 {detect_s:.2f} s later, quarantined {quarantined}; the next q1 from the "
            f"host tier (cost {dict(healed.cost)}) equal to the oracle; a flight-recorder bundle with both payloads "
            f"in a temporary directory")

    finally:
        s0.auditor.stop()
        s0.auditor = aud0
        s0.flightrec.dir = frec0
        s0.executor.clear_poisoned()
        for n, s in servers.items():
            injectors[n].heal()
            s.lane.fault_injector = None
            for seg in small:
                s.remove_segment(table, seg.segment_name)
        hb.shutdown()
        if cb is not None:
            cb.shutdown()
        shutil.rmtree(frec_dir, ignore_errors=True)
    torch.cuda.synchronize()
    totals = {"k1": fg.launches, "k2": vsc.launches}
    record["paths"]["planes"] = {"launches": {"cache_misses": saved}, "totals": totals}
    if totals["k1"] < 1 or totals["k2"] < 1:
        raise AssertionError(f"planes: launches {totals}")
    rec["wall_s"] = time.perf_counter() - t_phase
    log(f"path planes: launches {totals} (one-member; the cache's misses {saved}); planes (a): {rec['wall_s']:.1f} s")


def planes_deployed_checks(url: str, broker_url: str, admin: Dict[str, str], record) -> None:
    """18 (c). On phase 17's roles: every /debug surface of the planes
    answers 200 with the reference's top-level keys, and a table config's
    ``slo`` block reaches the networked broker's SLO tracker."""
    from pinot_tpu_torch.common.tableconfig import SloConfig, TableConfig
    from pinot_tpu_torch.tools.datagen import lineitem_schema

    t = time.perf_counter()
    rec = record.setdefault("planes", {})["deployed"] = {}
    for name, keys in PLANES_BROKER_KEYS.items():
        got = http_json(f"{broker_url}/debug/{name}")
        if set(got) != keys:
            raise AssertionError(f"planes deployed: the broker's /debug/{name} keys {sorted(got)}")
    for srv, a in admin.items():
        for name, keys in PLANES_SERVER_KEYS.items():
            got = http_json(f"{a}/debug/{name}")
            if set(got) != keys:
                raise AssertionError(f"planes deployed: {srv}'s /debug/{name} keys {sorted(got)}")
    schema = dict(lineitem_schema().to_json(), schemaName="slotab")
    http_json(url + "/schemas", json.dumps(schema).encode())
    config = TableConfig("slotab", slo=SloConfig(latency_ms=PLANES_SLO["latencyMs"],
                                                 latency_target=PLANES_SLO["latencyTarget"]))
    http_json(url + "/tables", json.dumps(config.to_json()).encode())

    def reached() -> bool:
        http_json(broker_url + "/query", json.dumps({"pql": "SELECT count(*) FROM slotab"}).encode())
        obj = http_json(broker_url + "/debug/slo")["tables"].get("slotab", {}).get("objective", {})
        return all(obj.get(k) == v for k, v in PLANES_SLO.items())

    wait_s = _wait_for("the slo block", reached, 60.0)
    rec.update(broker_surfaces=sorted(PLANES_BROKER_KEYS), server_surfaces=sorted(PLANES_SERVER_KEYS),
               slo_reached_s=wait_s, slo=PLANES_SLO, wall_s=time.perf_counter() - t)
    log(f"planes (c): the broker's /debug/{{{','.join(PLANES_BROKER_KEYS)}}} and both servers' "
        f"/debug/{{{','.join(PLANES_SERVER_KEYS)}}} answer with the reference's keys; the slotab table's slo block "
        f"{PLANES_SLO} in the networked broker's SloTracker {wait_s:.2f} s after AddTable; "
        f"{rec['wall_s']:.1f} s")


def check_freshness(label: str, d: dict, watermarks: Tuple[float, float], sent_ms: float, got_ms: float) -> float:
    """18 (b). A realtime answer's ``freshnessMs``: present, at least 0, and
    now minus the minimum watermark the servers stamp, at a moment between
    the request's send and its reply (the JSON's 3 decimals aside).  That
    watermark lies in ``watermarks`` = (low, high): high is the stalest
    partition's newest produced event; low, after a partition's segment
    rolled over, the event of the last block its first consumer indexed,
    which the server that committed it keeps (the registry is per process,
    as in the reference)."""
    low, high = watermarks
    f = d.get("freshnessMs")
    if f is None or f < 0 or not (sent_ms - high - 1.0 <= f <= got_ms - low + 1.0):
        raise AssertionError(f"realtime {label}: freshnessMs {f} against the watermarks {watermarks} "
                             f"({sent_ms - high:.1f} to {got_ms - low:.1f} ms)")
    return f


# ---------------------------------------------------------------------------
# 10. the deployed cluster: a controller, two servers and a broker, each
# its own process, through the admin CLI
# ---------------------------------------------------------------------------

REPO_DIR = os.path.dirname(os.path.abspath(__file__))
_ROLES: List["_Role"] = []  # every role process started, stopped at exit too


# A role that joins a controller not started yet: its interpreter imports
# the package (the most of a process's start) while the controller starts,
# then waits for the controller's URL in a file and runs the admin CLI's
# main() on its arguments with the URL in place of CONTROLLER_URL.
CONTROLLER_URL = "{controller}"
_ROLE_AFTER_URL = """
import os, sys, time
import pinot_tpu_torch.broker.network_starter
import pinot_tpu_torch.server.network_starter
from pinot_tpu_torch.tools import admin
path, deadline = sys.argv[1], time.monotonic() + float(sys.argv[2])
while not os.path.exists(path):
    if time.monotonic() > deadline:
        sys.exit("no controller URL in " + path)
    time.sleep(0.02)
with open(path) as f:
    url = f.read()
admin.main([url if a == "{controller}" else a for a in sys.argv[3:]])
"""


class _Role:
    """One role process: ``python -m pinot_tpu_torch.tools.admin <args>``
    from the checkout, its output in a log file.  With ``url_file`` the
    process starts before its controller: it loads the package, then runs
    the CLI once ``url_file`` holds the URL (``CONTROLLER_URL`` in
    ``args``)."""

    def __init__(self, name: str, args: List[str], log_dir: str, env: Optional[Dict[str, str]] = None,
                 url_file: Optional[str] = None) -> None:
        self.name = name
        self.log = open(os.path.join(log_dir, f"{name}.log"), "w+")
        env = dict(os.environ, PYTHONPATH=REPO_DIR + os.pathsep + os.environ.get("PYTHONPATH", ""), **(env or {}))
        cmd = (["-m", "pinot_tpu_torch.tools.admin"] if url_file is None
               else ["-c", _ROLE_AFTER_URL, url_file, str(DEPLOY_READY_S)])
        self.proc = subprocess.Popen([sys.executable, *cmd, *args],
                                     cwd=REPO_DIR, env=env, stdout=self.log, stderr=subprocess.STDOUT, text=True)
        self.terminated = False
        _ROLES.append(self)

    def tail(self, n: int = 3000) -> str:
        self.log.flush()
        self.log.seek(0)
        return self.log.read()[-n:]

    def check_alive(self) -> None:
        if self.proc.poll() is not None:
            raise AssertionError(f"deployed {self.name} exited with {self.proc.returncode}:\n{self.tail()}")

    def ready(self, deadline_s: float) -> List[str]:
        """The words of its ``READY`` line; raises when it exits first or
        prints none within ``deadline_s``."""
        end = time.monotonic() + deadline_s
        while time.monotonic() < end:
            self.check_alive()
            for line in self.tail(1 << 20).splitlines():
                if line.startswith("READY "):
                    return line.split()
            time.sleep(0.2)
        raise AssertionError(f"deployed {self.name}: not READY within {deadline_s} s:\n{self.tail()}")

    def terminate(self) -> None:
        """SIGTERM, once (a second one during the interpreter's exit, when
        the default action is back, would kill the role), no wait."""
        if self.proc.poll() is None and not self.terminated:
            self.terminated = True
            self.proc.terminate()

    def stop(self) -> int:
        """SIGTERM and a wait (a kill past 60 s); the exit code."""
        if self.proc.poll() is None:
            self.terminate()
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=60)
        self.log.close()
        return self.proc.returncode


def _stop_roles() -> Dict[str, int]:
    """Every role stopped: the brokers, servers and workers together
    (SIGTERM to each, then the waits), then the controllers they talk to."""
    roles = _ROLES[::-1]
    _ROLES.clear()
    codes = {}
    first = [r for r in roles if not r.name.startswith("controller")]
    for group in (first, [r for r in roles if r not in first]):
        for role in group:
            role.terminate()
        for role in group:
            codes[role.name] = role.stop()
    return codes


atexit.register(_stop_roles)


def http_json(url: str, data: bytes = None, ctype: str = "application/json") -> Any:
    req = urllib.request.Request(url, data=data, headers={"Content-Type": ctype} if data is not None else {})
    with urllib.request.urlopen(req, timeout=DEPLOY_REQUEST_S) as r:
        return json.loads(r.read())


def response_from_json(d: dict):
    """A broker reply's JSON as a ``BrokerResponse`` (values as the client
    reads them: integers, else floats of the printed decimals)."""
    from pinot_tpu_torch.common.response import (
        AggregationResult,
        BrokerResponse,
        GroupByResult,
        QueryException,
        SelectionResults,
    )

    def num(v):
        try:
            return int(v)
        except (TypeError, ValueError):
            return float(v)

    aggs = None
    if "aggregationResults" in d:
        aggs = []
        for a in d["aggregationResults"]:
            if "groupByResult" in a:
                aggs.append(AggregationResult(a["function"], group_by_columns=a["groupByColumns"], group_by_result=[
                    GroupByResult(list(g["group"]), num(g["value"])) for g in a["groupByResult"]]))
            else:
                aggs.append(AggregationResult(a["function"], value=num(a["value"])))
    sel = d.get("selectionResults")
    return BrokerResponse(
        aggregation_results=aggs,
        selection_results=None if sel is None else SelectionResults(sel["columns"], sel["results"]),
        exceptions=[QueryException(e["errorCode"], e["message"]) for e in d["exceptions"]],
        cost=d.get("cost", {}), time_used_ms=d.get("timeUsedMs", 0.0),
    )


def check_deployed(name: str, d: dict, want) -> None:
    """A reply of the deployed broker against its oracle, as phase 9
    holds its replies (selection rows as the client reads them)."""
    from pinot_tpu_torch.common.response import SelectionResults

    if name in SELECTION_QUERIES:
        if d["exceptions"] or d.get("cost", {}).get("segmentsHost"):
            raise AssertionError(f"deployed {name}: {d['exceptions']} {d.get('cost')}")
        cols, rows = want
        if d.get("selectionResults") != SelectionResults(cols, rows).to_json():
            raise AssertionError(f"deployed {name}: {d.get('selectionResults')} != oracle {cols} {rows}")
        return
    if name in ZONE_QUERIES:
        resp = response_from_json(d)
        if resp.exceptions or resp.cost.get("segmentsHost"):
            raise AssertionError(f"deployed {name}: {d['exceptions']} {resp.cost}")
        (check_response if name == "zone_in" else check_value_response)(resp, want)
        return
    check_served(name, response_from_json(d), want)


def require_launch(label: str, launches: Dict[str, int], kernel: str) -> None:
    """A query of the path must have launched ``kernel`` (None: no need)."""
    if kernel is not None and launches[kernel] < 1:
        raise AssertionError(f"{label}: kernel {kernel} was not launched")


def start_roles(tmp: str, rec: dict, server_env: Optional[Dict[str, str]] = None, device: str = DEPLOY_DEVICE,
                heartbeat_timeout: str = "60"):
    """A controller (its liveness window ``heartbeat_timeout`` seconds), two
    servers (``server_env`` added to their environment) and a broker, each
    its own process of the admin CLI on ``device``: (controller URL,
    {server: admin URL}, broker URL, a check that raises when a role
    exited)."""
    t = time.perf_counter()
    ctrl = _Role("controller", ["StartController", "-port", "0", "-data-dir", os.path.join(tmp, "controller"),
                                "-heartbeat-timeout", heartbeat_timeout, "-device", device], tmp)
    # the servers and the broker load the package meanwhile and join once
    # the controller is READY
    url_file = os.path.join(tmp, "controller.url")
    servers = {f"server{i}": _Role(f"server{i}", ["StartServer", "-controller", CONTROLLER_URL, "-name",
                                                  f"server{i}", "-port", "0", "-device", device, "-precision",
                                                  "x32"], tmp, env=server_env, url_file=url_file)
               for i in range(2)}
    broker = _Role("broker", ["StartBroker", "-controller", CONTROLLER_URL, "-port", "0", "-timeout-ms", "600000",
                              "-device", device], tmp, url_file=url_file)
    url = ctrl.ready(DEPLOY_READY_S)[2]
    with open(url_file + ".tmp", "w") as f:
        f.write(url)
    os.replace(url_file + ".tmp", url_file)
    admin = {n: r.ready(DEPLOY_READY_S)[-1] for n, r in servers.items()}
    broker_url = broker.ready(DEPLOY_READY_S)[2]
    start_s = time.perf_counter() - t
    log(f"deployed: controller {url}, servers {admin}, broker {broker_url}: every role READY in {start_s:.1f} s")
    rec["start_s"] = start_s

    # the roles of now: a controller restarted in its phase replaces ``ctrl``
    return url, admin, broker_url, _alive_roles


def wait_online(url: str, broker_url: str, table: str, n: int, alive) -> float:
    """Seconds until the broker routes all ``n`` segments of ``table`` ONLINE."""
    t = time.perf_counter()
    end = time.monotonic() + DEPLOY_ONLINE_S
    while True:
        alive()
        view = http_json(broker_url + "/debug/routing").get(table) or {}
        if len(view) == n and all(r and all(v == "ONLINE" for v in r.values()) for r in view.values()):
            return time.perf_counter() - t
        bad = {s_: r for s_, r in http_json(f"{url}/tables/{table}/externalview").items() if "ERROR" in r.values()}
        if bad:
            raise AssertionError(f"deployed: segments in ERROR {bad}")
        if time.monotonic() > end:
            raise AssertionError(f"deployed: not every segment of {table} ONLINE in {DEPLOY_ONLINE_S} s: {view}")
        time.sleep(0.2)


def deployed_phase(segments, wants, record, then=None) -> None:
    """10. The lineitem table as a deployment runs it: the segments written
    as files, a controller, two servers and a broker started as processes
    of the admin CLI, the files uploaded through the controller, and the
    queries sent to the broker's HTTP endpoint.  ``then``: called with the
    roles (controller URL, admin URLs, broker URL, alive check, the
    phase's directory) after the queries, before they stop."""
    from pinot_tpu_torch.common.tableconfig import TableConfig
    from pinot_tpu_torch.segment.format import write_segment
    from pinot_tpu_torch.tools.datagen import lineitem_schema

    rec = record["deployed"] = {"queries": {}}
    tmp = tempfile.mkdtemp(prefix="pinot-deployed-")
    t_phase = time.perf_counter()
    try:
        # the segment files, one thread a file (the bit packing runs in numpy)
        def write(seg):
            t = time.perf_counter()
            path = write_segment(seg, os.path.join(tmp, "files", seg.segment_name))
            return path, time.perf_counter() - t

        # the files are written while the role processes start
        threads = max(1, min(len(segments), os.cpu_count() or 1))
        t = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(threads) as pool:
            written = [pool.submit(write, seg) for seg in segments]
            url, admin, broker_url, alive = start_roles(tmp, rec)
            files, write_s = map(list, zip(*(w.result() for w in written)))
        write_wall = time.perf_counter() - t
        file_bytes = sum(os.path.getsize(f) for f in files)
        log(f"deployed: wrote {len(files)} segment files ({file_bytes} bytes, zone maps included) in "
            f"{threads} threads while the roles started ({write_wall:.1f} s for both), "
            f"{float(np.median(write_s)):.3f} s a segment (median, in its thread)")
        rec.update(write_s_per_segment=float(np.median(write_s)), write_s=write_wall, write_threads=threads,
                   file_bytes=file_bytes)
        servers = admin

        # schema, table, then the files through the controller
        http_json(url + "/schemas", json.dumps(lineitem_schema().to_json()).encode())
        http_json(url + "/tables", json.dumps(TableConfig("lineitem").to_json()).encode())
        table = "lineitem_OFFLINE"
        t = time.perf_counter()
        held = {n: 0 for n in servers}
        for path in files:
            with open(path, "rb") as f:
                reply = http_json(f"{url}/segments/{table}", f.read(), "application/octet-stream")
            for n in reply["servers"]:
                held[n] += 1
        upload_s = time.perf_counter() - t
        if sorted(held.values()) != [len(files) // 2] * 2:
            raise AssertionError(f"deployed: assignment {held}, not {len(files) // 2} segments a server")
        online_s = wait_online(url, broker_url, table, len(files), alive)
        loads = {n: http_json(a + "/debug/samples?timer=segmentLoad")["samples"] for n, a in admin.items()}
        if any(len(v) != len(files) // 2 for v in loads.values()):
            raise AssertionError(f"deployed: segment loads {loads}")
        log(f"deployed: upload of {len(files)} files {upload_s:.1f} s; from the last upload to every segment "
            f"ONLINE in the broker's routing {online_s:.1f} s; each server holds {held}; segment load ms per "
            f"server (median, max) { {n: (round(float(np.median(v)), 1), round(max(v), 1)) for n, v in loads.items()} }")
        rec.update(upload_s=upload_s, online_s=online_s, held=held,
                   load_ms={n: {"median": float(np.median(v)), "max": max(v), "all": v} for n, v in loads.items()})

        # pairs_distinct: each server trims its own groups first
        ideal = http_json(f"{url}/tables/{table}/idealstate")
        by_name = {s_.segment_name: s_ for s_ in segments}
        covers = [[by_name[s_] for s_ in sorted(ideal, key=lambda x: int(x[2:])) if n in ideal[s_]] for n in servers]
        wants = dict(wants, pairs_distinct=served_distinct_oracle(covers))
        pqls = {**QUERIES, **VALUE_QUERIES, **SELECTION_QUERIES, **PAIR_QUERIES, **ZONE_QUERIES}
        need = {"q1": "k1", "q3": "k1", "hll_groupby": "k2", "distinct_price": "k2", "pairs_distinct": "k1"}
        # the default servers answer the three-date lists from host postings,
        # as the reference's servers do: no launch, segmentsPostings

        def launches():
            out = {"k1": 0, "k2": 0}
            for a in admin.values():
                got = http_json(a + "/debug/metrics")["kernelLaunches"]
                out = {k: out[k] + got[k] for k in out}
            return out

        # the path: one request a query, the servers' launches read just
        # before and just after each
        per_query, totals = {}, {"k1": 0, "k2": 0}
        t = time.perf_counter()
        for name in DEPLOY_QUERIES:
            before = launches()
            d = http_json(broker_url + "/query", json.dumps({"pql": pqls[name]}).encode())
            after = launches()
            check_deployed(name, d, wants[name])
            per_query[name] = {k: after[k] - before[k] for k in after}
            totals = {k: totals[k] + per_query[name][k] for k in totals}
            require_launch(f"deployed {name}", per_query[name], need.get(name))
            if name in ZONE_QUERIES and (d.get("cost", {}).get("segmentsPostings") != len(files)
                                         or any(per_query[name].values())):
                raise AssertionError(f"deployed {name}: not served from postings: cost {d.get('cost')}, "
                                     f"launches {per_query[name]}")
        wall_s = time.perf_counter() - t
        record["paths"]["deployed"] = {"launches": per_query, "totals": totals, "wall_s": wall_s}
        log(f"path deployed (staging included): {wall_s:.1f} s, launches on the servers per query {per_query}, "
            f"total {totals}; every answer equal to its oracle through the broker's HTTP endpoint")
        status = {n: http_json(a + "/debug/metrics") for n, a in admin.items()}
        rec["batching"] = {n: dict(batchLaunches=st["lane"]["batchLaunches"],
                                   batchedQueries=st["lane"]["batchedQueries"],
                                   kernelLaunches=st["kernelLaunches"]) for n, st in status.items()}
        log(f"deployed: the servers' lanes at the batching defaults {rec['batching']}")

        # EXPLAIN through the deployed broker: the full scan, the zone
        # blocks, postings and the bit-sliced tier
        explained = {"q1": Q1, "zone_blocks": q1_at(SERVE_DATES[0]), "zone_in": ZONE_QUERIES["zone_in"],
                     "bsi_count_sum": BSI_QUERIES["bsi_count_sum"]}
        before = launches()
        rec["explain"] = explain_checks(
            "deployed", lambda pql: http_json(broker_url + "/query", json.dumps({"pql": pql}).encode()),
            lambda: {n: http_json(a + "/debug/metrics") for n, a in admin.items()}, explained,
            lambda name, d: check_deployed(name, d, wants[name]) if name in ("q1", "zone_in") else None)
        after = launches()
        record["paths"]["deployed_explain"] = {"launches": {}, "totals": {k: after[k] - before[k] for k in after}}

        # broker latency over SERVE_ITERS requests after warm-up (zone_distinct:
        # DEPLOY_FEW_ITERS), and the servers' own medians of those requests
        for name in DEPLOY_QUERIES:
            postings = name in ZONE_QUERIES
            few = name == "zone_distinct"
            iters, warmup = (DEPLOY_FEW_ITERS, 1) if few else (SERVE_ITERS, SERVE_WARMUP)
            phases = ("schedulerWait", "indexPath") if postings else \
                ("schedulerWait", "tierDecision", "staging", "planBuild", "laneWait", "laneDispatch", "planExec",
                 "finalize")
            body = json.dumps({"pql": pqls[name]}).encode()
            for _ in range(warmup):
                check_deployed(name, http_json(broker_url + "/query", body), wants[name])
            broker_ms, client_ms = [], []
            for _ in range(iters):
                t = time.perf_counter()
                d = http_json(broker_url + "/query", body)
                client_ms.append((time.perf_counter() - t) * 1e3)
                broker_ms.append(d["timeUsedMs"])
                if d["exceptions"] or d.get("cost", {}).get("segmentsHost"):
                    raise AssertionError(f"deployed {name}: {d['exceptions']} {d.get('cost')}")
            check_deployed(name, d, wants[name])
            split = {}
            for ph in phases:
                samples = []
                for a in admin.values():
                    samples += http_json(f"{a}/debug/samples?timer=phase.{ph}&last={iters}")["samples"]
                split[ph] = float(np.median(samples)) if samples else None
            # a p99 of a few requests is their maximum: name it so
            tail = "max" if few else "p99"
            top = max if few else (lambda v: np.percentile(v, 99))
            q = {"n": iters, "p50_ms": float(np.percentile(broker_ms, 50)), f"{tail}_ms": float(top(broker_ms)),
                 "client_p50_ms": float(np.percentile(client_ms, 50)), f"client_{tail}_ms": float(top(client_ms)),
                 "server_ms": split, "in_process_ms": record["query_ms"].get(name),
                 "phase9_p50_ms": record.get("serving", {}).get("queries", {}).get(name, {}).get("p50_ms")}
            rec["queries"][name] = q
            log(f"deployed {name}: broker p50 {q['p50_ms']:.3f} ms, {tail} {q[f'{tail}_ms']:.3f} ms over {iters} "
                f"(HTTP client p50 {q['client_p50_ms']:.3f}, {tail} {q[f'client_{tail}_ms']:.3f}); server medians "
                f"{ {k: (None if v is None else round(v, 4)) for k, v in split.items()} } ms")
        alive()
        if then is not None:
            then((url, admin, broker_url, alive, tmp))
    finally:
        codes = _stop_roles()
        rec["exit_codes"] = codes
        log(f"deployed: every role stopped with SIGTERM, exit codes {codes}; phase {time.perf_counter() - t_phase:.1f} s")
        shutil.rmtree(tmp, ignore_errors=True)
    if any(codes.values()):
        raise AssertionError(f"deployed: a role did not exit cleanly {codes}")


# ---------------------------------------------------------------------------
# 11. joins: the Star Schema Benchmark's lineorder / part / date (O'Neil,
# O'Neil, Chen, Revilak, TPCTC 2009) at lineorder SF ~2.8, three queries
# ---------------------------------------------------------------------------

SSB_PARTITIONS = 16  # lineorder and part partitioned on their part key, one segment a partition
# 16 x 2^20 = 16,777,216 lineorder rows: 6,000,000 x SF at SF ~2.8 (2^22, SF ~11.2, before phase 20; 2^21,
# SF ~5.6, before phase 21)
SSB_ROWS_PER_SEGMENT = 1 << 20
SSB_PARTS = 400_000  # 200,000 x floor(1 + log2 SF) (800,000 before phase 20, 600,000 before 21)
JOIN_QUERIES = {
    "ssb_q1_1": "SELECT count(*), sum(l.lo_extendedprice), sum(l.lo_discount) FROM lineorder l "
                "JOIN date d ON l.lo_orderdate = d.d_datekey WHERE d.d_year = 1993 "
                "AND l.lo_discount >= 1 AND l.lo_discount <= 3 AND l.lo_quantity < 25",
    "ssb_q2_1": "SELECT sum(l.lo_revenue), count(*) FROM lineorder l JOIN part p ON l.lo_partkey = p.p_partkey "
                "WHERE p.p_category = 'MFGR#12' GROUP BY p.p_brand1 TOP 40",
    "ssb_q2_1_mode": "SELECT sum(l.lo_revenue), min(p.p_size), max(l.lo_quantity) FROM lineorder l "
                     "JOIN part p ON l.lo_partkey = p.p_partkey WHERE p.p_category = 'MFGR#12' "
                     "GROUP BY p.p_brand1, l.lo_shipmode TOP 280",
}
# the strategy each query takes by the planner's own choice: date is small
# (broadcast), lineorder and part colocate on the part key
JOIN_STRATEGY = {"ssb_q1_1": "broadcast", "ssb_q2_1": "colocated", "ssb_q2_1_mode": "colocated"}
JOIN_BUILD_TABLE = {"ssb_q1_1": "date", "ssb_q2_1": "part", "ssb_q2_1_mode": "part"}
JOIN_ITERS = 1  # in-process runs on the host clock (each extracts up to 67M rows; 3 before phase 15, 2 before 16)
JOIN_SERVE_ITERS = 1  # broker requests a query over TCP (10 before phase 13, 6 before 14, 3 before 17, 2 before 18)
JOIN_SHUFFLE_ITERS = 1  # (5 before phase 13, 3 before phase 14, 2 before phase 15)
JOIN_DEPLOY_ITERS = 1  # (3 before phase 14, 2 before 17)
JOIN_PROGRAM_ITERS = 3  # CUDA-event medians of the device program (5 before phase 18)


def ssb_tables() -> Dict[str, list]:
    """{table: segments}: lineorder (SSB_PARTITIONS segments lineorder_pN),
    part (one segment a partition) and date, made from their seeds (the
    lineorder segments in threads: numpy releases the GIL in its draws and
    sorts)."""
    import concurrent.futures

    from pinot_tpu_torch.tools.datagen import ssb_date_segment, ssb_lineorder_segment, ssb_part_segments

    def lineorder(p: int):
        return ssb_lineorder_segment(SSB_ROWS_PER_SEGMENT, p, SSB_PARTITIONS, SSB_PARTS, seed=100 + p)

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        lo = list(pool.map(lineorder, range(SSB_PARTITIONS)))
    return {"lineorder": lo, "part": ssb_part_segments(SSB_PARTS, SSB_PARTITIONS), "date": [ssb_date_segment()]}


def _decoded(seg, col: str) -> np.ndarray:
    c = seg.column(col)
    return c.dictionary.value_array()[c.fwd]


def join_oracles(ssb: Dict[str, list]) -> Dict[str, Dict[Tuple[str, ...], Dict[str, float]]]:
    """Every join's answer by brute force over the generated arrays, in
    float64 numpy: part's columns looked up by part key (p_partkey is
    unique), date's by date key; {query: {group: {function: value}}}."""
    part_size = SSB_PARTS + 1
    cat_of = np.full(part_size, -1, np.int64)
    brand_of = np.full(part_size, -1, np.int64)
    size_of = np.zeros(part_size, np.int64)
    brands = sorted({str(b) for seg in ssb["part"] for b in seg.column("p_brand1").dictionary.values})
    brand_ix = {b: i for i, b in enumerate(brands)}
    cats = {c: i for i, c in enumerate(sorted({str(c) for seg in ssb["part"]
                                               for c in seg.column("p_category").dictionary.values}))}
    for seg in ssb["part"]:
        pk = _decoded(seg, "p_partkey").astype(np.int64)
        cat_of[pk] = [cats[str(c)] for c in _decoded(seg, "p_category")]
        brand_of[pk] = [brand_ix[str(b)] for b in _decoded(seg, "p_brand1")]
        size_of[pk] = _decoded(seg, "p_size")
    year_of = {int(k): int(y) for seg in ssb["date"]
               for k, y in zip(_decoded(seg, "d_datekey"), _decoded(seg, "d_year"))}
    years = np.zeros(max(year_of) + 1, np.int64)
    years[list(year_of)] = list(year_of.values())
    modes = sorted({str(m) for seg in ssb["lineorder"] for m in seg.column("lo_shipmode").dictionary.values})
    nb, nm = len(brands), len(modes)
    q11 = np.zeros(3)
    q21_sum, q21_cnt = np.zeros(nb), np.zeros(nb, np.int64)
    m_sum, m_cnt = np.zeros(nb * nm), np.zeros(nb * nm, np.int64)
    m_min, m_max = np.full(nb * nm, np.iinfo(np.int64).max), np.full(nb * nm, np.iinfo(np.int64).min)
    for seg in ssb["lineorder"]:
        od = _decoded(seg, "lo_orderdate").astype(np.int64)
        qty = _decoded(seg, "lo_quantity").astype(np.int64)
        disc = _decoded(seg, "lo_discount").astype(np.int64)
        m = (years[od] == 1993) & (disc >= 1) & (disc <= 3) & (qty < 25)
        q11 += [m.sum(), _decoded(seg, "lo_extendedprice")[m].astype(np.float64).sum(),
                disc[m].astype(np.float64).sum()]
        pk = _decoded(seg, "lo_partkey").astype(np.int64)
        hit = cat_of[pk] == cats["MFGR#12"]
        b = brand_of[pk[hit]]
        rev = _decoded(seg, "lo_revenue")[hit].astype(np.float64)
        q21_sum += np.bincount(b, weights=rev, minlength=nb)
        q21_cnt += np.bincount(b, minlength=nb)
        mode_ix = {str(v): i for i, v in enumerate(seg.column("lo_shipmode").dictionary.values)}
        remap = np.asarray([modes.index(v) for v in mode_ix])
        key = b * nm + remap[seg.column("lo_shipmode").fwd[hit]]
        m_sum += np.bincount(key, weights=rev, minlength=nb * nm)
        m_cnt += np.bincount(key, minlength=nb * nm)
        np.minimum.at(m_min, key, size_of[pk[hit]])
        np.maximum.at(m_max, key, qty[hit])
    out = {"ssb_q1_1": {(): {"count_star": int(q11[0]), "sum_lo_extendedprice": float(q11[1]),
                             "sum_lo_discount": float(q11[2])}},
           "ssb_q2_1": {(brands[i],): {"sum_lo_revenue": float(q21_sum[i]), "count_star": int(q21_cnt[i])}
                        for i in np.nonzero(q21_cnt)[0]},
           "ssb_q2_1_mode": {(brands[k // nm], modes[k % nm]): {
               "sum_lo_revenue": float(m_sum[k]), "min_part.p_size": float(m_min[k]),
               "max_lo_quantity": float(m_max[k])} for k in np.nonzero(m_cnt)[0]}}
    return out


def check_join(label: str, resp, want) -> float:
    """A join's answer against its oracle: every group, counts, min and max
    exact, sums within the audit band; returns the largest relative sum
    error."""
    if resp.exceptions:
        raise AssertionError(f"{label}: {[e.to_json() for e in resp.exceptions]}")
    worst = 0.0
    for ar in resp.aggregation_results:
        got = ({(): ar.value} if ar.group_by_result is None
               else {tuple(g.group): g.value for g in ar.group_by_result})
        if set(got) != set(want):
            raise AssertionError(f"{label} {ar.function}: groups {sorted(got)[:5]} != {sorted(want)[:5]} "
                                 f"({len(got)} vs {len(want)})")
        for key, v in got.items():
            w = want[key][ar.function]
            if ar.function.startswith(("count", "min", "max")):
                if float(v) != float(w):
                    raise AssertionError(f"{label} {ar.function} {key}: {v} != {w}")
                continue
            if not math.isclose(float(v), w, rel_tol=AUDIT_RTOL, abs_tol=AUDIT_ATOL):
                raise AssertionError(f"{label} {ar.function} {key}: {v} vs oracle {w}")
            worst = max(worst, abs(float(v) - w) / max(abs(w), 1e-30))
    return worst


def check_join_device(label: str, resp) -> None:
    """Served by the device program: deviceBytes in the cost."""
    if not resp.cost.get("deviceBytes"):
        raise AssertionError(f"{label}: not served by the device program, cost {resp.cost}")


def join_request(name: str, table: str, jctx: dict, strategy: Optional[str] = None) -> dict:
    """A server's decoded join-phase request (``ServerInstance._process``)."""
    return {"requestId": f"join-{name}", "pql": JOIN_QUERIES[name], "table": table, "segments": [],
            "timeoutMs": 600_000.0, "trace": False, "debugOptions": {}, "join": jctx}


def join_data():
    """The SSB tables and their oracles, timed."""
    t = time.perf_counter()
    ssb = ssb_tables()
    log(f"joins datagen: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    wants = join_oracles(ssb)
    log(f"joins oracles (float64 numpy over the generated arrays): {time.perf_counter() - t:.1f} s; groups "
        f"{ {k: len(v) for k, v in wants.items()} }")
    return ssb, wants


def join_phase(dev, ssb, wants, record, fg, vsc) -> None:
    """11. Joins in process through a server's join phases (every
    strategy's exec phase), the stages timed apart, the program against
    its plain version and K1 at the join's shape; then through two servers
    and the broker over TCP; then a poisoned join plan."""
    from pinot_tpu_torch.common.faults import DeviceFaultInjector
    from pinot_tpu_torch.engine import join as jm
    from pinot_tpu_torch.engine import kernel as kernel_mod
    from pinot_tpu_torch.engine.device import to_device_inputs
    from pinot_tpu_torch.engine.reduce import reduce_to_response
    from pinot_tpu_torch.pql import optimize_request, parse_pql
    from pinot_tpu_torch.server.instance import ServerInstance

    rec = record.setdefault("joins", {})
    rec.update(queries={}, stages={}, serve={})
    lo_rows = sum(s.num_docs for s in ssb["lineorder"])
    log(f"joins: lineorder {len(ssb['lineorder'])} x {SSB_ROWS_PER_SEGMENT} = {lo_rows} rows, part "
        f"{sum(s.num_docs for s in ssb['part'])} rows in {len(ssb['part'])} segments, date "
        f"{ssb['date'][0].num_docs} rows")
    injector = DeviceFaultInjector()
    server = ServerInstance("joins", device=dev, precision="x32", device_fault_injector=injector)
    for table, segs in ssb.items():
        for seg in segs:
            server.add_segment(table, seg)
    requests = {k: optimize_request(parse_pql(v)) for k, v in JOIN_QUERIES.items()}

    def extract(name: str, side: str) -> dict:
        table = "lineorder" if side == "probe" else JOIN_BUILD_TABLE[name]
        res = server._process(join_request(name, table, {"phase": "extract", "side": side}))
        if res.exceptions:
            raise AssertionError(f"join {name} extract {side}: {res.exceptions}")
        return res.join_payload

    def jctx(name: str, strategy: str) -> dict:
        if strategy == "colocated":
            return {"phase": "exec", "strategy": "colocated", "buildTable": JOIN_BUILD_TABLE[name],
                    "buildSegments": [s.segment_name for s in ssb[JOIN_BUILD_TABLE[name]]]}
        if strategy == "broadcast":
            return {"phase": "exec", "strategy": "broadcast", "build": extract(name, "build")}
        return {"phase": "exec", "strategy": "shuffle", "build": extract(name, "build"),
                "probe": extract(name, "probe")}

    def run(name: str, ctx: dict, label: str):
        res = server._process(join_request(name, "lineorder", ctx))
        resp = reduce_to_response(requests[name], [res], [])
        err = check_join(label, resp, wants[name])
        check_join_device(label, res)
        return res, err

    try:
        # the path: each query once under its strategy, every launch count 0
        # just before and read just after; the grouped sums launch K1, no K2
        ctxs = {name: jctx(name, JOIN_STRATEGY[name]) for name in JOIN_QUERIES}
        fg.launches = 0
        vsc.launches = 0
        kernel_mod.join_dispatches = 0
        per_query = {}
        t = time.perf_counter()
        for name in JOIN_QUERIES:
            before = fg.launches, vsc.launches
            _, err = run(name, ctxs[name], f"join {name}")
            per_query[name] = {"k1": fg.launches - before[0], "k2": vsc.launches - before[1]}
            if name != "ssb_q1_1" and per_query[name]["k1"] < 1:
                raise AssertionError(f"join {name}: K1 was not launched for the grouped sums")
            rec["queries"].setdefault(name, {})["max_rel_err"] = err
        torch.cuda.synchronize()
        totals = {"k1": fg.launches, "k2": vsc.launches}
        if totals["k2"] or kernel_mod.join_dispatches != len(JOIN_QUERIES):
            raise AssertionError(f"joins: K2 launched {totals['k2']}, join programs {kernel_mod.join_dispatches}")
        wall_s = time.perf_counter() - t
        record.setdefault("paths", {})["joins"] = {"launches": per_query, "totals": totals, "wall_s": wall_s}
        log(f"path joins (extraction included): {wall_s:.1f} s, launches per query {per_query}, total {totals}; "
            f"every answer equal to its float64 oracle, from the device program")

        # each strategy's exec phase, timed (host clock, median of JOIN_ITERS)
        for name, strategies in (("ssb_q1_1", ("broadcast", "shuffle")), ("ssb_q2_1", ("colocated",)),
                                 ("ssb_q2_1_mode", ("colocated",))):
            for strategy in strategies:
                ctx = ctxs[name] if strategy == JOIN_STRATEGY[name] else jctx(name, strategy)
                walls, costs = [], []
                for _ in range(JOIN_ITERS):
                    t = time.perf_counter()
                    res, err = run(name, ctx, f"join {name} {strategy}")
                    walls.append((time.perf_counter() - t) * 1e3)
                    costs.append(res.cost)
                # the server's own timer of the local extraction (probe, and
                # build when colocated) in each of these runs
                ext_ms = (server.metrics.timer("phase.joinExtract").samples()[-JOIN_ITERS:]
                          if strategy != "shuffle" else [])
                q = rec["queries"][name].setdefault("exec", {})[strategy] = dict(
                    ms=float(np.median(walls)), runs=walls, cost=costs[-1], max_rel_err=err,
                    extract_ms=float(np.median(ext_ms)) if ext_ms else None)
                log(f"join {name} {strategy} exec phase in process: {q['ms']:.1f} ms (median of {JOIN_ITERS}, host "
                    f"clock; runs {[round(w, 1) for w in walls]}), local extraction "
                    f"{q['extract_ms'] if ext_ms else 0.0:.1f} ms of it (median), cost {costs[-1]}")

        # the stages apart: host extraction, packing, upload, the program
        # (CUDA events), finalize; the program against its plain version;
        # K1 at the join's shape against its plain version and its bound
        for name in JOIN_QUERIES:
            req = requests[name]
            spec = req.join
            left_f, right_f = jm.split_join_filter(req)
            left_cols, right_cols = jm.side_columns(req)
            bsegs, psegs = ssb[JOIN_BUILD_TABLE[name]], ssb["lineorder"]
            t = time.perf_counter()
            build, _ = jm.extract_side(bsegs, right_f, spec.right_key, [spec.strip_right(c) for c in right_cols],
                                       {spec.strip_right(c): c for c in right_cols})
            build_ms = (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            probe, _ = jm.extract_side(psegs, left_f, spec.left_key, left_cols)
            probe_ms = (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            plan, inputs, meta = jm.build_join_plan(req, build, probe, "x32")
            pack_ms = (time.perf_counter() - t) * 1e3
            up_bytes = sum(a.nbytes for a in inputs.values())
            torch.cuda.synchronize()
            t = time.perf_counter()
            q = to_device_inputs(inputs, dev)
            torch.cuda.synchronize()
            up_ms = (time.perf_counter() - t) * 1e3
            stats: Dict[str, int] = {}
            prog_ms, _ = cuda_ms(lambda: kernel_mod.run_join_kernel(plan, q, stats), JOIN_PROGRAM_ITERS, warmup=1)
            outs = kernel_mod.run_join_kernel(plan, q)
            plain = kernel_mod.join_kernel_reference(plan, q)
            plain_ms, _ = cuda_ms(lambda: kernel_mod.join_kernel_reference(plan, q), 1, warmup=0)
            prog_err = compare_join_outputs(name, plan, outs, plain)
            fetched = {k: (tuple(x.cpu().numpy() for x in v) if isinstance(v, tuple) else v.cpu().numpy())
                       for k, v in outs.items()}
            fins = []
            for _ in range(JOIN_PROGRAM_ITERS):
                t = time.perf_counter()
                res = jm.finalize_device_join(req, plan, meta, build, probe, fetched)
                fins.append((time.perf_counter() - t) * 1e3)
            check_join(f"join {name} stages", reduce_to_response(req, [res], []), wants[name])
            st = rec["stages"][name] = dict(
                build_extract_ms=build_ms, probe_extract_ms=probe_ms,
                build_rows=build.n, probe_rows=probe.n, pack_ms=pack_ms, upload_bytes=up_bytes, upload_ms=up_ms,
                program_ms=prog_ms, plain_ms=plain_ms, program_max_abs_err=prog_err,
                build_rounds=stats["build_rounds"], probe_rounds=stats["probe_rounds"],
                finalize_ms=float(np.median(fins)), n_probe_pad=plan.n_probe_pad, cap=plan.cap,
                n_groups=plan.n_groups, joined_rows=int(outs["num_docs"]))
            log(f"join {name} stages: extraction build {st['build_extract_ms']:.1f} ms ({build.n} rows), probe "
                f"{st['probe_extract_ms']:.1f} ms ({probe.n} rows) (one run, host clock); packing "
                f"{pack_ms:.1f} ms; upload {up_bytes} bytes in {up_ms:.1f} ms; program {prog_ms:.3f} ms (CUDA events, "
                f"median of {JOIN_PROGRAM_ITERS}; {stats['build_rounds']} build rounds, {stats['probe_rounds']} "
                f"probe rounds over {plan.n_probe_pad} lanes, cap {plan.cap}); plain version {plain_ms:.3f} ms, "
                f"max_abs_err {prog_err:.6g}; finalize {st['finalize_ms']:.3f} ms; {st['joined_rows']} joined rows")
            if plan.n_groups:
                st["k1"] = k1_at_join(fg, kernel_mod, plan, q, name)
            del q, outs, plain
            torch.cuda.empty_cache()

        heal = server.executor.healing_stats()
        if heal["hostFailovers"] or heal["deviceFailures"]:
            raise AssertionError(f"joins: the device path healed {heal}")
        # a poisoned join plan: the next launch fails deterministically, the
        # plan is quarantined and the host join answers the same
        injector.fail_next(1, retryable=False)
        resp_res = server._process(join_request("ssb_q1_1", "lineorder", ctxs["ssb_q1_1"]))
        check_join("join ssb_q1_1 poisoned", reduce_to_response(requests["ssb_q1_1"], [resp_res], []),
                   wants["ssb_q1_1"])
        heal = server.executor.healing_stats()
        if resp_res.cost.get("deviceBytes") or heal["hostFailovers"] != 1 or heal["poisonedPlans"] != 1:
            raise AssertionError(f"joins poisoned: cost {resp_res.cost}, heal {heal}")
        log(f"join ssb_q1_1 poisoned plan: healed to the host join, equal to its oracle (hostMs "
            f"{resp_res.cost.get('hostMs')}), heal {heal}")
        rec["poisoned"] = {"heal": heal, "host_ms": resp_res.cost.get("hostMs")}
    finally:
        server.shutdown()
    torch.cuda.empty_cache()
    join_serve_phase(dev, ssb, wants, record)


def compare_join_outputs(name: str, plan, outs, plain) -> float:
    """The program against its plain version on the same card tensors:
    num_docs, counts, min and max exact, sums within the audit band (K1's
    order against float64 ``index_add_``); the largest absolute sum error."""
    if int(outs["num_docs"]) != int(plain["num_docs"]) or not bool(outs["join_ok"]):
        raise AssertionError(f"join {name}: num_docs {int(outs['num_docs'])} != {int(plain['num_docs'])}")
    err = 0.0
    if plan.n_groups and not torch.equal(outs["gb_cnt"], plain["gb_cnt"]):
        raise AssertionError(f"join {name}: group counts differ from the plain version")
    for i, (kind, _s, _x) in enumerate(plan.aggs):
        key = f"gb_{i}" if plan.n_groups else f"agg_{i}"
        got, want = outs[key], plain[key]
        pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
        for g, w in pairs:
            if kind in ("sum", "avg"):
                err = max(err, _close(g.reshape(-1), w.reshape(-1), AUDIT_RTOL, AUDIT_ATOL))
            elif not torch.equal(g, w):
                raise AssertionError(f"join {name}: {key} ({kind}) differs from the plain version")
    return err


def k1_captured(fg, label: str, run) -> dict:
    """K1 at the shape a path hands it: its last launch in ``run()``,
    captured, against its plain version in every tier that takes it, timed
    (CUDA events) and beside its bound on this data."""
    captured: dict = {}
    restore = _capture(fg, "fused_filtered_groupby_sums", captured, "k1")
    try:
        run()
    finally:
        fg.fused_filtered_groupby_sums = restore
    names = ("filter_fwd", "match", "num_docs", "group_keys", "value_fwds", "value_dicts", "capacity")
    a, k = captured["k1"]
    args = {**dict(zip(names, a)), **k}
    args.setdefault("filter_bounds", None)
    args.setdefault("group_cols", None)
    err, tiers = compare_k1(fg, args, AUDIT_RTOL, AUDIT_ATOL)
    tier = fg.choose_tier(*k1_shape(fg, args))
    k_ms, _ = cuda_ms(lambda: fg.fused_filtered_groupby_sums(**args), ITERS)
    p_ms, _ = cuda_ms(lambda: fg.fused_filtered_groupby_sums_reference(**args), 1, warmup=0)
    matched = int(fg.fused_filtered_groupby_sums(**args)[0])
    bound, bound_by, nbytes, ops = k1_bound(args, matched)
    form = "group_keys" if args["group_keys"] is not None else "group_cols"
    lead = next(t for t in (args["group_keys"], *(args["group_cols"] or ()), args["filter_fwd"],
                            *args["value_fwds"], *args["value_raws"]) if t is not None)
    filt = "none" if args["filter_fwd"] is None else ("match" if args["match"] is not None else "interval")
    log(f"k1 {label} ({form} {str(lead.dtype).replace('torch.', '')} {list(lead.shape)}, filter {filt}, "
        f"K={args['capacity']}, nv={len(args['value_raws'])}, tier {tier}, {matched} rows matched): {k_ms:.4f} ms "
        f"(bound {bound:.4f} ms by {bound_by}: {nbytes} bytes, {ops} operations; {bound / k_ms:.3f} of the bound), "
        f"plain {p_ms:.4f} ms, tiers checked {tiers}, max_abs_err {err:.6g}")
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=bound_by, bytes=nbytes, operations=ops,
                tier=tier, tiers=tiers, shape=list(lead.shape), key_form=form, filter=filt,
                capacity=args["capacity"], matched=matched, max_abs_err=err)


def k1_at_join(fg, kernel_mod, plan, q, name: str) -> dict:
    """K1 at the join's launch shape (the {0, 1} match over the matched
    lanes, the precombined key, the weight streams), captured from one
    program run."""
    return k1_captured(fg, f"join {name}", lambda: kernel_mod.run_join_kernel(plan, q))


def join_serve_phase(dev, ssb, wants, record) -> None:
    """11b. Two port servers behind the broker over TCP (phase 9's layout:
    lineorder split 8 + 8, part and date on both): each query by the
    planner's own choice, ssb_q1_1 forced to shuffle, broker p50 / p99,
    the join cost keys."""
    from pinot_tpu_torch.broker.broker import BrokerRequestHandler
    from pinot_tpu_torch.broker.routing import RoutingTableProvider
    from pinot_tpu_torch.server.instance import ServerInstance
    from pinot_tpu_torch.transport.tcp import TcpServer, TcpTransport

    rec = record["joins"]["serve"]
    half = len(ssb["lineorder"]) // 2
    covers = {"server0": ssb["lineorder"][:half], "server1": ssb["lineorder"][half:]}
    servers, tcp = {}, {}
    routing = RoutingTableProvider()
    for name, segs in covers.items():
        server = servers[name] = ServerInstance(name, device=dev, precision="x32")
        for seg in segs:
            server.add_segment("lineorder", seg)
        for table in ("part", "date"):
            for seg in ssb[table]:
                server.add_segment(table, seg)
        tcp[name] = TcpServer(server.handle_request)
        tcp[name].start()
    routing.update("lineorder", {s.segment_name: {n: "ONLINE"} for n, segs in covers.items() for s in segs})
    for table in ("part", "date"):
        routing.update(table, {s.segment_name: {n: "ONLINE" for n in covers} for s in ssb[table]})
    broker = BrokerRequestHandler(TcpTransport(), {n: t.address for n, t in tcp.items()}, routing=routing,
                                  timeout_ms=600_000)
    broker.joinplan.partitions.set_partitioning("lineorder", "lo_partkey", SSB_PARTITIONS)
    broker.joinplan.partitions.set_partitioning("part", "p_partkey", SSB_PARTITIONS)
    try:
        for name, strategy, iters in (("ssb_q1_1", None, JOIN_SERVE_ITERS), ("ssb_q2_1", None, JOIN_SERVE_ITERS),
                                      ("ssb_q2_1_mode", None, JOIN_DEPLOY_ITERS),
                                      ("ssb_q1_1", "shuffle", JOIN_SHUFFLE_ITERS)):
            want_strategy = strategy or JOIN_STRATEGY[name]
            meter = broker.metrics.meter(f"join.strategy.{want_strategy}")
            before = meter.count
            opts = {"joinStrategy": strategy} if strategy else None
            broker_ms, client_ms, worst = [], [], 0.0
            for _ in range(iters + 1):  # one warm-up
                t = time.perf_counter()
                resp = broker.handle_pql(JOIN_QUERIES[name], debug_options=opts)
                client_ms.append((time.perf_counter() - t) * 1e3)
                broker_ms.append(resp.time_used_ms)
                worst = max(worst, check_join(f"serve join {name} {want_strategy}", resp, wants[name]))
                check_join_device(f"serve join {name}", resp)
            if meter.count - before != iters + 1:
                raise AssertionError(f"serve join {name}: strategy {want_strategy} taken "
                                     f"{meter.count - before} of {iters + 1} times")
            broker_ms, client_ms = broker_ms[1:], client_ms[1:]
            keys = {k: resp.cost.get(k) for k in ("buildRows", "probeRows", "broadcastBytes", "shuffleBytes",
                                                  "deviceBytes", "deviceMs", "hostMs")}
            q = rec[f"{name}/{want_strategy}"] = dict(
                p50_ms=float(np.percentile(broker_ms, 50)), p99_ms=float(np.percentile(broker_ms, 99)),
                client_p50_ms=float(np.percentile(client_ms, 50)), requests=iters, cost=keys, max_rel_err=worst,
                runs=broker_ms)
            log(f"serve join {name} {want_strategy}: broker p50 {q['p50_ms']:.1f} ms, p99 {q['p99_ms']:.1f} ms over "
                f"{iters} requests (client p50 {q['client_p50_ms']:.1f}); every answer equal to its oracle; cost {keys}")
        heal = {n: s.executor.healing_stats() for n, s in servers.items()}
        if any(h["hostFailovers"] or h["deviceFailures"] for h in heal.values()):
            raise AssertionError(f"serve joins: the device path healed {heal}")
        rec["heal"] = heal
    finally:
        broker.shutdown()
        for t in tcp.values():
            t.stop()
        for s in servers.values():
            s.shutdown()
        torch.cuda.empty_cache()


def deployed_join_phase(ssb, wants, record, roles=None) -> None:
    """11c. ssb_q2_1 through a deployed cluster (phase 10's layout: a
    controller, two servers and a broker, each a process of the admin
    CLI): lineorder and part declared partitioned on their part keys
    through ``AddTable`` (part on both servers), the segment files
    uploaded through the controller, the query over HTTP: colocated, each
    answer against the oracle, K1 launched on the servers.  ``roles``:
    phase 10's (controller URL, admin URLs, broker URL, alive check, its
    directory), left running for the caller to stop; else its own."""
    from pinot_tpu_torch.common.tableconfig import PartitionConfig, TableConfig
    from pinot_tpu_torch.segment.format import write_segment
    from pinot_tpu_torch.tools.datagen import lineorder_schema, part_schema

    rec = record.setdefault("joins", {})["deployed"] = {}
    t_phase = time.perf_counter()
    if roles is None:
        tmp = tempfile.mkdtemp(prefix="pinot-joins-")
    else:
        url, admin, broker_url, alive, tmp = roles
    codes = {}
    try:
        if roles is None:
            url, admin, broker_url, alive = start_roles(tmp, rec)
        env = dict(os.environ, PYTHONPATH=REPO_DIR + os.pathsep + os.environ.get("PYTHONPATH", ""))
        adds = []  # the two AddTable processes run at once
        for table, schema, key, replication in (("lineorder", lineorder_schema(), "lo_partkey", 1),
                                                ("part", part_schema(), "p_partkey", 2)):
            http_json(url + "/schemas", json.dumps(schema.to_json()).encode())
            config_file = os.path.join(tmp, f"{table}.json")
            with open(config_file, "w") as f:
                json.dump(TableConfig(table, replication=replication,
                                      partitioning=PartitionConfig(key, SSB_PARTITIONS)).to_json(), f)
            adds.append(subprocess.Popen([sys.executable, "-m", "pinot_tpu_torch.tools.admin", "AddTable",
                                          "-controller", url, "-config-file", config_file], cwd=REPO_DIR, env=env,
                                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for p in adds:
            out = p.communicate(timeout=120)[0]
            if p.returncode != 0:
                raise AssertionError(f"deployed joins: AddTable exited with {p.returncode}:\n{out[-3000:]}")
        t = time.perf_counter()
        tables = [(table, seg) for table in ("lineorder", "part") for seg in ssb[table]]
        # one thread a file (the bit packing runs in numpy), uploaded in order
        with concurrent.futures.ThreadPoolExecutor(max(1, os.cpu_count() or 1)) as pool:
            paths = list(pool.map(lambda ts: write_segment(ts[1], os.path.join(tmp, "files", ts[1].segment_name)),
                                  tables))
        for (table, _), path in zip(tables, paths):
            with open(path, "rb") as f:
                http_json(f"{url}/segments/{table}_OFFLINE", f.read(), "application/octet-stream")
        upload_s = time.perf_counter() - t
        online_s = max(wait_online(url, broker_url, f"{t_}_OFFLINE", len(ssb[t_]), alive)
                       for t_ in ("lineorder", "part"))
        log(f"deployed joins: {len(ssb['lineorder'])} lineorder and {len(ssb['part'])} part segment files written "
            f"and uploaded in {upload_s:.1f} s, every segment ONLINE {online_s:.1f} s after")

        def meters(u: str) -> dict:
            return http_json(u + "/debug/metrics")["meters"]

        def launches() -> int:
            return sum(http_json(a + "/debug/metrics")["kernelLaunches"]["k1"] for a in admin.values())

        body = json.dumps({"pql": JOIN_QUERIES["ssb_q2_1"]}).encode()
        # the broker learns the partitioning from the cluster state it polls
        end = time.monotonic() + 60
        while meters(broker_url).get("join.strategy.colocated", {}).get("count", 0) == 0:
            if time.monotonic() > end:
                raise AssertionError(f"deployed joins: never colocated {meters(broker_url)}")
            d = http_json(broker_url + "/query", body)
            check_join("deployed join ssb_q2_1", response_from_json(d), wants["ssb_q2_1"])
        before, k1_before = meters(broker_url)["join.strategy.colocated"]["count"], launches()
        broker_ms, client_ms = [], []
        for _ in range(JOIN_DEPLOY_ITERS):
            t = time.perf_counter()
            d = http_json(broker_url + "/query", body)
            client_ms.append((time.perf_counter() - t) * 1e3)
            broker_ms.append(d["timeUsedMs"])
            resp = response_from_json(d)
            check_join("deployed join ssb_q2_1", resp, wants["ssb_q2_1"])
            check_join_device("deployed join ssb_q2_1", resp)
        colocated = meters(broker_url)["join.strategy.colocated"]["count"] - before
        k1 = launches() - k1_before
        if colocated != JOIN_DEPLOY_ITERS:
            raise AssertionError(f"deployed joins: {colocated} of {JOIN_DEPLOY_ITERS} requests colocated")
        require_launch("deployed join ssb_q2_1", {"k1": k1}, "k1")
        rec.update(p50_ms=float(np.percentile(broker_ms, 50)), p99_ms=float(np.percentile(broker_ms, 99)),
                   client_p50_ms=float(np.percentile(client_ms, 50)), runs=broker_ms, upload_s=upload_s,
                   online_s=online_s, k1_launches=k1, cost=resp.cost)
        log(f"deployed join ssb_q2_1 colocated over HTTP: broker p50 {rec['p50_ms']:.1f} ms, p99 {rec['p99_ms']:.1f} "
            f"ms over {JOIN_DEPLOY_ITERS} (client p50 {rec['client_p50_ms']:.1f}); K1 launches on the servers {k1}; "
            f"cost {resp.cost}")
        # the join's EXPLAIN: the coordinator's shell, nothing sent to a
        # server; ANALYZE executes, its actuals the reply's cost
        def marks() -> dict:
            return {n: _server_marks(http_json(a + "/debug/metrics")) for n, a in admin.items()}

        def ask(prefix: str) -> dict:
            return http_json(broker_url + "/query", json.dumps({"pql": prefix + JOIN_QUERIES["ssb_q2_1"]}).encode())

        before = marks()
        plan = ask("EXPLAIN ")
        if plan["exceptions"] or plan["explain"]["join"]["strategy"] != "colocated" or marks() != before:
            raise AssertionError(f"deployed join explain: {plan}, servers {before} -> {marks()}")
        k1_before = launches()
        an = ask("EXPLAIN ANALYZE ")
        check_join("deployed join explain analyze ssb_q2_1", response_from_json(an), wants["ssb_q2_1"])
        if an["explain"]["join"]["actual"]["strategy"] != "colocated" or an["explain"]["actualCost"] != an["cost"]:
            raise AssertionError(f"deployed join explain analyze: {an['explain']} against cost {an['cost']}")
        require_launch("deployed join explain analyze ssb_q2_1", {"k1": launches() - k1_before}, "k1")
        ms = [ask("EXPLAIN ")["timeUsedMs"] for _ in range(EXPLAIN_ITERS)]
        rec["explain"] = {"strategy": "colocated", "explain_p50_ms": float(np.percentile(ms, 50)),
                          "explain_max_ms": float(max(ms)), "analyze_cost": an["cost"]}
        log(f"deployed join explain ssb_q2_1: the colocated plan with nothing sent to a server; ANALYZE equal to the "
            f"oracle, actualCost = cost; broker EXPLAIN p50 {rec['explain']['explain_p50_ms']:.3f} ms")
        alive()
    finally:
        if roles is None:
            codes = _stop_roles()
            rec["exit_codes"] = codes
            shutil.rmtree(tmp, ignore_errors=True)
        said = f"every role stopped, exit codes {codes}" if roles is None else "on phase 10's roles"
        log(f"deployed joins: {said}; {time.perf_counter() - t_phase:.1f} s")
    if any(codes.values()):
        raise AssertionError(f"deployed joins: a role did not exit cleanly {codes}")


# ---------------------------------------------------------------------------
# 12. star-tree tables: the reference's two cube configurations
# (pinot_tpu/tools/startree_scale.py:81-127, STARTREE_SCALE_r5.json) at
# full size
# ---------------------------------------------------------------------------

ST_BASEBALL_SEGMENTS = 4  # 4 x 2^23 = 33,554,432 baseballStats rows (8 before phase 19)
ST_BASEBALL_SEED = 200  # segment i draws from seed 200 + i
ST_ITERS = 3  # timed runs per cube / scan median (20 before phase 15, 10 before 17, 5 before 21)
ST_SERVE_ITERS = 10  # broker requests per served query, after warm-up (50 before phase 15, 20 before 17)
ST_CLI_ROWS = 10_000
ST_QUERIES = {
    "bb_cube": "SELECT sum(runs), count(*) FROM baseballStats GROUP BY teamID TOP 20",
    "bb_cube_filtered": ("SELECT sum(runs), count(*) FROM baseballStats WHERE league = 'AL' "
                         "AND yearID BETWEEN 1990 AND 2005 GROUP BY teamID TOP 20"),
    "bb_not_fit": "SELECT max(runs), count(*) FROM baseballStats GROUP BY teamID TOP 20",
}
ST_FIT = ("bb_cube", "bb_cube_filtered", "ns_cube")
# adevents_hll_cube: one tree per distinct ad-events segment
ST_AD_CONFIG = dict(split_order=["campaign_id", "site_id"], hll_columns=["user_id"], max_leaf_records=64)
ST_PRUNED = {  # past every segment's event_time range: the time pruner drops them all
    "pruned_count": "SELECT count(*) FROM adevents WHERE event_time > 1800000000000",
    "pruned_select": "SELECT * FROM adevents WHERE event_time > 1800000000000 LIMIT 5",
}


def baseball_oracle(segments, name: str) -> Dict[Tuple[str, ...], Dict[str, float]]:
    """{(teamID,): {"count", "sum_runs", "max_runs"}} in float64 numpy
    over the host segments, independently of the engine and the cube."""
    acc: Dict[Tuple[str, ...], Dict[str, float]] = {}
    for seg in segments:
        team, runs = seg.column("teamID"), seg.column("runs")
        mask = np.ones(seg.num_docs, dtype=bool)
        if name == "bb_cube_filtered":
            lg, yr = seg.column("league"), seg.column("yearID")
            years = np.asarray(yr.dictionary.values)[yr.fwd]
            mask = (np.asarray(lg.dictionary.values, dtype=object) == "AL")[lg.fwd]
            mask &= (years >= 1990) & (years <= 2005)
        k, r = team.fwd[mask].astype(np.int64), runs.fwd[mask].astype(np.int64)
        values = np.asarray(runs.dictionary.values, dtype=np.float64)
        n_t, n_r = team.dictionary.cardinality, runs.dictionary.cardinality
        cnt = np.bincount(k, minlength=n_t)
        tot = np.bincount(k, weights=values[r], minlength=n_t)
        hit = np.bincount(k * n_r + r, minlength=n_t * n_r).reshape(n_t, n_r) > 0
        for t, lab in enumerate(team.dictionary.values):
            if cnt[t]:
                e = acc.setdefault((lab,), {"count": 0, "sum_runs": 0.0, "max_runs": -math.inf})
                e["count"] += int(cnt[t])
                e["sum_runs"] += float(tot[t])
                e["max_runs"] = max(e["max_runs"], float(values[np.nonzero(hit[t])[0][-1]]))
    return acc


def rows_oracle(rows: List[dict], name: str) -> Dict[Tuple[str, ...], Dict[str, float]]:
    """``baseball_oracle`` over plain rows (the CLI's input, before any build)."""
    acc: Dict[Tuple[str, ...], Dict[str, float]] = {}
    for r in rows:
        if name == "bb_cube_filtered" and not (r["league"] == "AL" and 1990 <= r["yearID"] <= 2005):
            continue
        e = acc.setdefault((r["teamID"],), {"count": 0, "sum_runs": 0.0, "max_runs": -math.inf})
        e["count"] += 1
        e["sum_runs"] += float(r["runs"])
        e["max_runs"] = max(e["max_runs"], float(r["runs"]))
    return acc


def _trees_equal(a, b) -> bool:
    return (a.split_order == b.split_order and np.array_equal(a.dims, b.dims)
            and np.array_equal(a.sums, b.sums) and np.array_equal(a.counts, b.counts)
            and json.dumps(a.root.to_json()) == json.dumps(b.root.to_json())
            and sorted(a.hll_registers) == sorted(b.hll_registers)
            and all(np.array_equal(a.hll_registers[c], b.hll_registers[c]) for c in a.hll_registers))


def _detach(segments) -> list:
    """Each segment's tree, set to None on the segment (``_attach`` undoes it)."""
    trees = [getattr(s, "star_tree", None) for s in segments]
    for s in segments:
        s.star_tree = None
    return trees


def _attach(segments, trees) -> None:
    for s, t in zip(segments, trees):
        s.star_tree = t


def host_ms(fn, iters: int) -> Tuple[float, List[float]]:
    """Median ms of ``iters`` calls on the host clock, after one warm-up."""
    fn()
    times = []
    for _ in range(iters):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times)), times


def cube_profile(executor_mod, ex, segs, req, iters: int) -> dict:
    """Where a cube query's host time goes: the per-segment operator
    (``execute_star_tree``: traversal, cube-row gathers, group states)
    against the rest of ``execute`` (the merge of the partials) and the
    broker reduce, medians of ``iters`` on the host clock; then the
    functions of one call under cProfile by their own time."""
    import cProfile
    import pstats

    from pinot_tpu_torch.engine.reduce import reduce_to_response

    real, spent = executor_mod.execute_star_tree, []

    def timed(*a, **k):
        t = time.perf_counter()
        try:
            return real(*a, **k)
        finally:
            spent.append(time.perf_counter() - t)

    parts: Dict[str, List[float]] = {"operator_ms": [], "merge_ms": [], "reduce_ms": []}
    executor_mod.execute_star_tree = timed
    try:
        for _ in range(iters):
            spent.clear()
            t0 = time.perf_counter()
            res = ex.execute(segs, req)
            t1 = time.perf_counter()
            reduce_to_response(req, [res])
            t2 = time.perf_counter()
            parts["operator_ms"].append(sum(spent) * 1e3)
            parts["merge_ms"].append((t1 - t0 - sum(spent)) * 1e3)
            parts["reduce_ms"].append((t2 - t1) * 1e3)
    finally:
        executor_mod.execute_star_tree = real
    prof = cProfile.Profile()
    prof.enable()
    reduce_to_response(req, [ex.execute(segs, req)])
    prof.disable()
    rows = [(v[2] * 1e3, v[3] * 1e3, v[1], f"{os.path.basename(fn)}:{line}({fname})")
            for (fn, line, fname), v in pstats.Stats(prof).stats.items()]
    total = sum(r[0] for r in rows)
    top = [dict(fn=r[3], own_ms=r[0], cum_ms=r[1], calls=r[2]) for r in sorted(rows, reverse=True)[:10]]
    return {**{k: float(np.median(v)) for k, v in parts.items()}, "profiled_ms": total, "top_own": top}


def _plain_copy(seg, name: str):
    """A segment of the same column arrays under ``name``, with no tree."""
    import dataclasses

    from pinot_tpu_torch.segment.immutable import ImmutableSegment

    return ImmutableSegment(metadata=dataclasses.replace(seg.metadata, segment_name=name), columns=seg.columns)


def startree_phase(dev, record, fg, vsc, ad_distinct=None, ns_want=None) -> None:
    """12. baseball_cube (4 x 2^23 rows, StarTreeBuilderConfig defaults) and
    adevents_hll_cube (phase 4's 4 distinct ad-events segments tiled to 16,
    one tree per distinct segment): the builds, every query from the cube
    and from K1 / K2 with the trees detached, a mixed table, the files
    served over TCP and their EXPLAIN, the CLI's row builder, and the
    pruner's repair.  ``ad_distinct`` / ``ns_want``: phase 4's segments and
    north-star oracle, made here when None."""
    import csv

    from pinot_tpu_torch.engine import executor as executor_mod
    from pinot_tpu_torch.engine import hll as hll_mod
    from pinot_tpu_torch.engine.executor import QueryExecutor
    from pinot_tpu_torch.engine.reduce import reduce_to_response
    from pinot_tpu_torch.pql import optimize_request, parse_pql
    from pinot_tpu_torch.segment.format import read_segment, write_segment
    from pinot_tpu_torch.startree import StarTreeBuilderConfig, build_star_tree
    from pinot_tpu_torch.tools.datagen import (
        adevents_schema,
        baseball_rows,
        baseball_schema,
        synthetic_adevents_segment,
        synthetic_baseball_segment,
        tile_segments,
    )

    parse = lambda pql: optimize_request(parse_pql(pql))  # noqa: E731
    paths = record.setdefault("paths", {})
    rec = record["startree"] = {"cpu_count": os.cpu_count()}

    # 12.1 the data and the tree builds (host numpy)
    t0 = time.perf_counter()
    bb = [synthetic_baseball_segment(ROWS_PER_SEGMENT, seed=ST_BASEBALL_SEED + i, name=f"bb{i}")
          for i in range(ST_BASEBALL_SEGMENTS)]
    if ad_distinct is None:
        ad_distinct = [synthetic_adevents_segment(ROWS_PER_SEGMENT, seed=7 + i, name=f"ad{i}",
                                                  campaign_card=AD_CAMPAIGNS, user_card=AD_USERS)
                       for i in range(AD_DISTINCT)]
        for s in ad_distinct:  # the per-dictionary hashing, outside the timed builds
            hll_mod.dictionary_tables(s.column("user_id").dictionary)
    ad = tile_segments(ad_distinct, SEGMENTS)
    log(f"startree datagen: baseball {ST_BASEBALL_SEGMENTS} x {ROWS_PER_SEGMENT} rows, ad-events {AD_DISTINCT} "
        f"distinct tiled to {SEGMENTS}, in {time.perf_counter() - t0:.1f} s")
    builds = {}
    for config, segs, schema, cfg in (
        ("baseball_cube", bb, baseball_schema(), StarTreeBuilderConfig()),
        ("adevents_hll_cube", ad_distinct, adevents_schema(), StarTreeBuilderConfig(**ST_AD_CONFIG)),
    ):
        def build(seg, schema=schema, cfg=cfg):
            t = time.perf_counter()
            build_star_tree(seg, schema, cfg)
            return time.perf_counter() - t

        # one thread a segment (the builds are numpy, mostly outside the
        # GIL; one after another before phase 17)
        threads = max(1, min(len(segs), os.cpu_count() or 1))
        t = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(threads) as pool:
            secs = list(pool.map(build, segs))
        wall = time.perf_counter() - t
        cube_rows = [seg.star_tree.num_records for seg in segs]
        builds[config] = {"build_s": secs, "wall_s": wall, "threads": threads, "cube_rows": cube_rows,
                          "raw_rows": ROWS_PER_SEGMENT, "split_order": segs[0].star_tree.split_order}
        log(f"startree build {config}: {wall:.1f} s wall in {threads} threads, {[round(x, 3) for x in secs]} s "
            f"per segment in its thread (median {float(np.median(secs)):.3f}) on the host ({os.cpu_count()} "
            f"CPUs), cube rows per segment {cube_rows} of {ROWS_PER_SEGMENT} raw, split order "
            f"{segs[0].star_tree.split_order}")
    # a tile shares its base segment's column arrays (tile_segments), so the
    # base's tree is a sound tree of the tile: each tile gets its base's
    for i, s in enumerate(ad):
        s.star_tree = ad_distinct[i % AD_DISTINCT].star_tree
    rec["build"] = builds

    # the routes line's entries (star-fit segments take the cube first)
    record_routes(record, "startree", ST_QUERIES, bb, parse)

    # 12.2 every query from the cube, then from K1 / K2 with the trees detached
    tables = {"bb_cube": bb, "bb_cube_filtered": bb, "bb_not_fit": bb, "ns_cube": ad}
    reqs = {k: parse(v) for k, v in {**ST_QUERIES, "ns_cube": NORTH_STAR}.items()}
    t0 = time.perf_counter()
    wants = {k: baseball_oracle(bb, k) for k in ST_QUERIES}
    wants["ns_cube"] = ns_want if ns_want is not None else north_star_oracle(hll_mod, ad)
    log(f"startree oracles: {time.perf_counter() - t0:.1f} s")

    def check(label: str, name: str, resp, want=None) -> float:
        want = wants[name] if want is None else want
        if resp.exceptions:
            raise AssertionError(f"{label}: {[e.to_json() for e in resp.exceptions]}")
        if name == "ns_cube":
            check_value_response(resp, want)
            return 0.0
        return check_response(resp, want)

    def run_path(path: str, names, ex, segs_of=None, pqls=None) -> Dict[str, Any]:
        """One run of each query, every launch count 0 just before and read
        just after: {name: (partial, response)}."""
        fg.launches = 0
        vsc.launches = 0
        per, out = {}, {}
        t = time.perf_counter()
        for name in names:
            k1, k2 = fg.launches, vsc.launches
            req = parse(pqls[name]) if pqls else reqs[name]
            res = ex.execute((segs_of or tables)[name], req)
            out[name] = (res, reduce_to_response(req, [res]))
            per[name] = {"k1": fg.launches - k1, "k2": vsc.launches - k2}
        torch.cuda.synchronize()
        totals = {"k1": fg.launches, "k2": vsc.launches}
        paths[path] = {"launches": per, "totals": totals, "wall_s": time.perf_counter() - t}
        log(f"path {path}: launches per query {per}, total {totals}")
        return out

    ex = QueryExecutor(device=dev, precision="x32")
    cube = run_path("startree_cube", ["bb_cube", "bb_cube_filtered", "ns_cube", "bb_not_fit"], ex)
    rec["queries"] = {}
    for name, (res, resp) in cube.items():
        n_segs = len(tables[name])
        worst = check(f"cube {name}", name, resp)
        if name in ST_FIT:
            if res._served_tier != "starTree" or res.cost.get("segmentsStarTree") != n_segs \
                    or paths["startree_cube"]["launches"][name] != {"k1": 0, "k2": 0}:
                raise AssertionError(f"cube {name}: tier {res._served_tier}, cost {res.cost}, launches "
                                     f"{paths['startree_cube']['launches'][name]}")
        else:  # max() is not star-fit: the scan serves it, through K1
            require_launch(f"cube {name}", paths["startree_cube"]["launches"][name], "k1")
            if res._served_tier != "device" or res.cost.get("segmentsStarTree"):
                raise AssertionError(f"cube {name}: tier {res._served_tier}, cost {res.cost}")
        rec["queries"][name] = {"cube_docs_scanned": res.num_docs_scanned, "cube_max_rel_err": worst,
                                "cube_cost": dict(res.cost)}
        log(f"startree {name} from the {res._served_tier} tier: equal to its oracle (max rel sum err "
            f"{worst:.3g}), numDocsScanned {res.num_docs_scanned} of {res.total_docs}, cost {res.cost}")
    for name in ST_FIT:
        segs, req = tables[name], reqs[name]
        ms, _ = host_ms(lambda: reduce_to_response(req, [ex.execute(segs, req)]), ST_ITERS)
        rec["queries"][name]["cube_ms"] = ms
        prof = rec["queries"][name]["cube_profile"] = cube_profile(executor_mod, ex, segs, req, ST_ITERS)
        log(f"startree {name} cube host time (medians of {ST_ITERS}): execute_star_tree over {len(segs)} segments "
            f"{prof['operator_ms']:.3f} ms, the rest of execute (the merge of the partials) {prof['merge_ms']:.3f} "
            f"ms, broker reduce {prof['reduce_ms']:.3f} ms; one call under cProfile {prof['profiled_ms']:.3f} ms, "
            f"by own time:")
        for r in prof["top_own"]:
            log(f"  {r['own_ms']:9.3f} ms own {r['cum_ms']:9.3f} ms cumulative {r['calls']:7d} calls  {r['fn']}")
    # K1 at the shapes only this phase hands it, each against its plain
    # version: the max() fallback over the 8 baseball segments
    rec["k1"] = {"bb_not_fit": dict(k1_captured(fg, "startree bb_not_fit",
                                                lambda: ex.execute(bb, reqs["bb_not_fit"])),
                                    path="startree_cube",
                                    launches=paths["startree_cube"]["launches"]["bb_not_fit"]["k1"])}
    saved_bb, saved_ad = _detach(bb), _detach(ad)
    try:
        scan = run_path("startree_scan", list(ST_FIT), ex)
        for name in ST_FIT:
            res, resp = scan[name]
            require_launch(f"scan {name}", paths["startree_scan"]["launches"][name], "k1")
            if res._served_tier != "device" or res.cost.get("segmentsStarTree"):
                raise AssertionError(f"scan {name}: tier {res._served_tier}, cost {res.cost}")
            worst = check(f"scan {name}", name, resp)
            cube_resp = cube[name][1]
            if name == "ns_cube":  # the cube's registers are the max over the same raw rows
                same = [a.to_json() for a in resp.aggregation_results] == \
                    [a.to_json() for a in cube_resp.aggregation_results]
                if not same:
                    raise AssertionError("ns_cube: the cube's HLL answer differs from the scan's")
            else:  # counts exact, sums in the audit band
                check_response(resp, response_as_want(cube_resp))
            segs, req = tables[name], reqs[name]
            ms, _ = cuda_ms(lambda: reduce_to_response(req, [ex.execute(segs, req)]), ST_ITERS)
            q = rec["queries"][name]
            q.update(scan_ms=ms, scan_docs_scanned=res.num_docs_scanned, scan_max_rel_err=worst,
                     launches=paths["startree_scan"]["launches"][name])
            log(f"startree {name}: cube {q['cube_ms']:.3f} ms (host clock, median of {ST_ITERS}) over "
                f"{q['cube_docs_scanned']} cube rows; scan {ms:.3f} ms (CUDA events, median of {ST_ITERS}) "
                f"over {res.num_docs_scanned} rows, launches {q['launches']}; scan / cube "
                f"{ms / q['cube_ms']:.3f}; the answers agree (HLL and counts exact, sums in the audit band)")
            if name != "ns_cube":  # ns_cube's scan is phase 4's north_star shape
                rec["k1"][f"scan {name}"] = dict(k1_captured(fg, f"startree scan {name}",
                                                             lambda: ex.execute(segs, req)),
                                                 path="startree_scan", launches=q["launches"]["k1"])
        rec["staged_bytes_scan"] = ex.staged_bytes()
    finally:
        _attach(bb, saved_bb)
        _attach(ad, saved_ad)
    ex.free_staging()
    del ex
    torch.cuda.empty_cache()

    # 12.3 a mixed table: trees on half the segments; the cube's partials
    # merge with K1's / K2's from the card
    mex = QueryExecutor(device=dev, precision="x32")
    half_bb, half_ad = _detach(bb[len(bb) // 2:]), _detach(ad[len(ad) // 2:])
    try:
        run_path("startree_mixed_full", ["bb_not_fit"], mex)  # stages all 8 baseball segments
        staged_full = mex.staged_bytes()
        mixed = run_path("startree_mixed", list(ST_FIT), mex)
        staged_after = mex.staged_bytes()
        # each staged table: (segments, columns, bytes); the star-fit
        # queries stage their plain halves as tables of their own
        tables_staged = sorted((len(key[0]), list(key[1]), st.nbytes()) for key, st in mex._staged.items())
        for name, (res, resp) in mixed.items():
            n = len(tables[name])
            require_launch(f"mixed {name}", paths["startree_mixed"]["launches"][name], "k1")
            tiers = {k: v for k, v in res.cost.items() if k.startswith("segments")}
            if tiers.get("segmentsStarTree") != n // 2 or sum(tiers.values()) != n:
                raise AssertionError(f"mixed {name}: tiers {tiers} over {n} live segments")
            worst = check(f"mixed {name}", name, resp)
            rec["queries"][name]["mixed"] = {"tiers": tiers, "docs_scanned": res.num_docs_scanned,
                                             "max_rel_err": worst}
            log(f"startree mixed {name}: cube and scan partials merged, tiers {tiers} over {n} live segments, "
                f"equal to its oracle (max rel sum err {worst:.3g})")
        # K1 over the plain halves: 4 baseball segments, 8 ad-events tiles
        for name in ST_FIT:
            rec["k1"][f"mixed {name}"] = dict(
                k1_captured(fg, f"startree mixed {name}", lambda: mex.execute(tables[name], reqs[name])),
                path="startree_mixed", launches=paths["startree_mixed"]["launches"][name]["k1"])
        rec["mixed_staged_bytes"] = {"full_set": staged_full, "with_the_split_subsets": staged_after,
                                     "tables": tables_staged}
        log(f"startree mixed staging: {staged_full} bytes with the 8 baseball segments staged for bb_not_fit, "
            f"{staged_after} after the star-fit queries staged their plain halves (+{staged_after - staged_full}); "
            f"staged tables (segments, columns, bytes) {tables_staged}")
    finally:
        _attach(bb[len(bb) // 2:], half_bb)
        _attach(ad[len(ad) // 2:], half_ad)
    mex.free_staging()
    del mex
    torch.cuda.empty_cache()

    # 12.4 the star-tree files, read back and served by two port servers
    # behind the port broker over TCP
    tmp = tempfile.mkdtemp(prefix="startree_")
    fleet = None
    try:
        # one file a thread: the bit packing and unpacking run in numpy
        with concurrent.futures.ThreadPoolExecutor(len(bb)) as pool:
            t = time.perf_counter()
            files = list(pool.map(lambda s: write_segment(s, os.path.join(tmp, s.segment_name)), bb))
            write_s = time.perf_counter() - t
            t = time.perf_counter()
            loaded = list(pool.map(read_segment, files))
            read_s = time.perf_counter() - t
        for a, b in zip(loaded, bb):
            if not _trees_equal(a.star_tree, b.star_tree):
                raise AssertionError(f"startree file {b.segment_name}: the tree read back differs")
        nbytes = sum(os.path.getsize(p) for p in files)
        log(f"startree files: {len(files)} written in {write_s:.1f} s ({nbytes} bytes), read back in "
            f"{read_s:.1f} s (one thread a file), every tree equal to the one written")
        rec["files"] = {"write_s": write_s, "read_s": read_s, "bytes": nbytes}
        half = len(loaded) // 2
        fleet = _Fleet(dev, {"server0": loaded[:half], "server1": loaded[half:]}, table="baseballStats")
        # baseballMixed: on each server half its files with their trees,
        # half as tree-less segments of the same arrays
        fleet.add_table("baseballMixed", {
            n: segs[:len(segs) // 2] + [_plain_copy(s, f"{s.segment_name}_plain") for s in segs[len(segs) // 2:]]
            for n, segs in (("server0", loaded[:half]), ("server1", loaded[half:]))})
        served = {"bb_cube": ST_QUERIES["bb_cube"],
                  "bb_mixed": ST_QUERIES["bb_cube"].replace("FROM baseballStats", "FROM baseballMixed")}
        fg.launches = 0
        vsc.launches = 0
        per = {}
        for name, pql in served.items():
            k1 = fg.launches
            resp = fleet.broker.handle_pql(pql)
            per[name] = {"k1": fg.launches - k1, "k2": 0}
            check(f"serve {name}", "bb_cube", resp)
            star = resp.cost.get("segmentsStarTree")
            if (name == "bb_cube" and (star != len(bb) or per[name]["k1"])) or \
                    (name == "bb_mixed" and (star != len(bb) // 2 or not per[name]["k1"])):
                raise AssertionError(f"serve {name}: cost {resp.cost}, launches {per[name]}")
        torch.cuda.synchronize()
        paths["startree_serving"] = {"launches": per, "totals": {"k1": fg.launches, "k2": vsc.launches}}
        log(f"path startree_serving: launches per query {per}; both answers equal to the oracle")
        rec["serving"] = {}
        for name, pql in served.items():
            for _ in range(SERVE_WARMUP):
                fleet.broker.handle_pql(pql)
            broker_ms = []
            for _ in range(ST_SERVE_ITERS):
                resp = fleet.broker.handle_pql(pql)
                broker_ms.append(resp.time_used_ms)
            check(f"serve {name}", "bb_cube", resp)
            q = {"p50_ms": float(np.percentile(broker_ms, 50)), "p99_ms": float(np.percentile(broker_ms, 99)),
                 "cost": dict(resp.cost)}
            rec["serving"][name] = q
            log(f"serve startree {name}: broker p50 {q['p50_ms']:.3f} ms, p99 {q['p99_ms']:.3f} ms over "
                f"{ST_SERVE_ITERS} requests, cost {resp.cost}")

        # EXPLAIN over the cube and the mixed table: plain EXPLAIN moves
        # nothing, its tiers are the executed ones, ANALYZE's actuals the cost
        fg.launches = 0
        vsc.launches = 0
        rec["explain"] = explain_checks(
            "startree", lambda pql: fleet.broker.handle_pql(pql).to_json(),
            lambda: {n: s_.status() for n, s_ in fleet.servers.items()}, served,
            lambda name, d: check(f"explain {name}", "bb_cube", response_from_json(d)))
        paths["startree_explain"] = {"launches": {}, "totals": {"k1": fg.launches, "k2": vsc.launches}}
    finally:
        if fleet is not None:
            fleet.close()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()

    # 12.5 the CLI: CreateSegment -startree on a CSV and a JSONL of baseball
    # rows, ShowSegment, and the phase's queries from the built segment
    tmp = tempfile.mkdtemp(prefix="startree_cli_")
    try:
        rows = baseball_rows(ST_CLI_ROWS, seed=99)
        schema_file = os.path.join(tmp, "schema.json")
        with open(schema_file, "w") as f:
            json.dump(baseball_schema().to_json(), f)
        with open(os.path.join(tmp, "rows.csv"), "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
        with open(os.path.join(tmp, "rows.jsonl"), "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
        env = dict(os.environ, PYTHONPATH=REPO_DIR + os.pathsep + os.environ.get("PYTHONPATH", ""))

        def admin(*args) -> str:
            p = subprocess.run([sys.executable, "-m", "pinot_tpu_torch.tools.admin", *args], cwd=REPO_DIR,
                               env=env, capture_output=True, text=True, timeout=600)
            if p.returncode != 0:
                raise AssertionError(f"admin {args[0]}: exit {p.returncode}\n{p.stdout[-2000:]}{p.stderr[-2000:]}")
            return p.stdout

        def create(fmt: str):
            out_dir = os.path.join(tmp, f"bb_cli_{fmt}")
            t = time.perf_counter()
            said = admin("CreateSegment", "-schema-file", schema_file, "-data-file", os.path.join(tmp, f"rows.{fmt}"),
                         "-table", "baseballStats", "-segment-name", f"bb_cli_{fmt}", "-out-dir", out_dir, "-startree")
            create_s = time.perf_counter() - t
            return out_dir, said, create_s, json.loads(admin("ShowSegment", "-segment-dir", out_dir))

        # both formats' CLI processes at once (each pays its interpreter's start)
        with concurrent.futures.ThreadPoolExecutor(2) as cli_pool:
            made = dict(zip(("csv", "jsonl"), cli_pool.map(create, ("csv", "jsonl"))))
        cex = QueryExecutor(device=dev, precision="x32")
        rec["cli"] = {}
        for fmt in ("csv", "jsonl"):
            out_dir, said, create_s, meta = made[fmt]
            if meta["numDocs"] != ST_CLI_ROWS or "starTree" not in meta["custom"]:
                raise AssertionError(f"cli {fmt}: ShowSegment {meta}")
            seg = read_segment(out_dir)
            out = run_path(f"startree_cli_{fmt}", list(ST_QUERIES), cex, segs_of={k: [seg] for k in ST_QUERIES})
            for name, (res, resp) in out.items():
                check(f"cli {fmt} {name}", name, resp, rows_oracle(rows, name))
                fit = name in ST_FIT
                if (res._served_tier == "starTree") != fit:
                    raise AssertionError(f"cli {fmt} {name}: tier {res._served_tier}")
            require_launch(f"cli {fmt} bb_not_fit", paths[f"startree_cli_{fmt}"]["launches"]["bb_not_fit"], "k1")
            if fmt == "csv":  # K1 over the one 10,000-row segment (the JSONL build is the same shape)
                rec["k1"]["cli bb_not_fit"] = dict(
                    k1_captured(fg, "startree cli bb_not_fit", lambda: cex.execute([seg], reqs["bb_not_fit"])),
                    path="startree_cli_csv", launches=paths["startree_cli_csv"]["launches"]["bb_not_fit"]["k1"])
            rec["cli"][fmt] = {"create_s": create_s, "cube_rows": meta["custom"]["starTree"]["numRecords"]}
            log(f"startree cli {fmt}: {said.strip()} in {create_s:.1f} s (process start included, both formats at "
                f"once); ShowSegment "
                f"{meta['numDocs']} docs, {meta['custom']['starTree']['numRecords']} cube rows; every query equal "
                f"to the oracle of the rows")
        del cex
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 12.6 the time pruner on the card: event_time is the ad-events
    # table's time column; its [start, end] as the row builder stamps it
    for s in ad:
        d = s.column("event_time").dictionary
        s.metadata.start_time, s.metadata.end_time = int(d.min_value), int(d.max_value)
    pex = QueryExecutor(device=dev, precision="x32")
    pruned = run_path("startree_pruned", list(ST_PRUNED), pex, segs_of={k: ad for k in ST_PRUNED}, pqls=ST_PRUNED)
    for name, (res, resp) in pruned.items():
        d = resp.to_json()
        if res.cost != {"segmentsPruned": len(ad)} or d["numSegmentsQueried"] != 0 or pex.staged_bytes():
            raise AssertionError(f"pruned {name}: cost {res.cost}, {d}")
        if name == "pruned_count" and int(resp.aggregation_results[0].value) != 0:
            raise AssertionError(f"pruned {name}: {d}")
        if name == "pruned_select" and (d["selectionResults"]["columns"] or d["selectionResults"]["results"]):
            raise AssertionError(f"pruned {name}: {d}")
    if paths["startree_pruned"]["totals"] != {"k1": 0, "k2": 0}:
        raise AssertionError(f"pruned: kernels launched {paths['startree_pruned']['totals']}")
    log(f"startree pruned: {len(ST_PRUNED)} queries past every event_time range: segmentsPruned {len(ad)}, "
        f"numSegmentsQueried 0, the empty shapes (count 0, no columns), nothing staged, no kernel launch")
    for s in ad_distinct:
        s.star_tree = None


# ---------------------------------------------------------------------------
# 13. the two filter tiers ahead of the scan: host postings (inverted
# indexes) and the bit-sliced tier's bitwise passes over bit-planes, on
# phase 1's lineitem; where they route, what they cost against the scan
# they replace, and the crossovers on the card
# ---------------------------------------------------------------------------

TIER_COLUMNS = ("l_shipdate", "l_quantity", "l_extendedprice")  # postings built and warmed at load
TIER_DATES = (1, 3, 16, 64)  # l_shipdate IN lists (the last past the 1/64 crossover)
# l_extendedprice BETWEEN ranges holding about these shares of the table
# (the last just under the 1/64 crossover); 0 is one price, the needle
TIER_PRICE_SHARES = (0.0, 1 / 4096, 1 / 1024, 1 / 256, 1 / 80)
TIER_SEGMENTS = 8  # phase 1's first 8 segments (all 16 before phase 21)
TIER_ITERS = 3  # medians of the ladders' routes (20 before phase 15, 10 before 16, 5 before 21)
_ZONE_SELECT = ("SELECT sum(l_quantity), sum(l_extendedprice), sum(l_discount), count(*) FROM lineitem "
                "WHERE {where} GROUP BY l_returnflag, l_linestatus TOP 10")
BSI_QUERIES = {
    "bsi_count_sum": "SELECT count(*), sum(l_quantity) FROM lineitem "
    "WHERE l_quantity IN (5, 10, 15) AND l_shipmode = 'AIR'",
    # an OR at the root with a negated points leaf: not postings-drivable
    "bsi_or_minmax": "SELECT count(*), min(l_quantity), max(l_quantity) FROM lineitem "
    "WHERE l_quantity NOT IN (1, 2) OR l_shipmode = 'AIR'",
}
BSI_BATCH_LITERALS = ((5, 10, 15), (1, 2, 3), (20, 25, 30), (4, 8, 12), (33, 36, 39), (41, 44, 47),
                      (6, 7, 9), (11, 13, 17))
BSI_BATCH_SIZES = (1, 4, 8)


def default_route(req, segs) -> Tuple[str, str]:
    """The tier the default executor serves ``req`` over ``segs`` from, by
    the two tiers' own decisions ahead of the scan: "postings",
    "bitsliced" or "scan" (zone blocks, a full scan or the host tier), with
    the deciding reason."""
    from pinot_tpu_torch.engine.bitsliced import bitsliced_decision
    from pinot_tpu_torch.engine.context import TableContext
    from pinot_tpu_torch.engine.invindex_path import index_path_decision

    ctx, total = TableContext(segs), sum(s.num_docs for s in segs)
    post, _ = index_path_decision(req, segs, ctx, total)
    if post["taken"]:
        return "postings", post["reason"]
    bsi, _ = bitsliced_decision(req, segs, ctx, total)
    if bsi["taken"]:
        return "bitsliced", bsi["reason"]
    return "scan", f"postings: {post['reason']}; bitsliced: {bsi['reason']}"


def record_routes(record, label: str, pqls: Dict[str, str], segs, parse) -> None:
    routes = record.setdefault("routes", {})
    for name, pql in pqls.items():
        routes[f"{label}/{name}"] = default_route(parse(pql), segs)


def _share(col, ids) -> float:
    """The share of the segment's rows whose dictId is in ``ids``."""
    counts = np.bincount(np.asarray(col.fwd), minlength=col.dictionary.cardinality)
    return float(counts[list(ids)].sum() / counts.sum())


def _price_range(segments, share: float) -> Tuple[str, float]:
    """A BETWEEN over l_extendedprice holding about ``share`` of segment 0's
    rows, from its median price up; returns the filter and the share it
    holds there."""
    col = segments[0].column("l_extendedprice")
    counts = np.bincount(np.asarray(col.fwd), minlength=col.dictionary.cardinality)
    cum = np.cumsum(counts) / counts.sum()
    lo = int(np.searchsorted(cum, 0.5))
    start = cum[lo - 1] if lo else 0.0
    hi = min(max(lo, int(np.searchsorted(cum, start + share))), counts.size - 1)
    d = col.dictionary
    return f"l_extendedprice BETWEEN {d.get(lo)!r} AND {d.get(hi)!r}", _share(col, range(lo, hi + 1))


def _crossover(rows: List[int], post_ms: List[float], other_ms: List[float], total: int) -> dict:
    """Where the postings query and the other route take the same time,
    from the ladder's points (ascending matched rows): linear between the
    last point postings wins and the first it loses; below the first point
    or above the last when it never changes sides there.  Beside it the
    least-squares slope of the postings ms over the matched rows."""
    slope = float(np.polyfit(np.asarray(rows, dtype=np.float64), np.asarray(post_ms), 1)[0]) if len(rows) > 1 \
        else float("nan")
    diff = [p - o for p, o in zip(post_ms, other_ms)]
    out = {"ms_per_million_rows": slope * 1e6, "points": list(zip(rows, post_ms, other_ms))}
    if diff[0] >= 0:
        out.update(where="below the smallest point", crossover_rows=None, crossover_share=None,
                   below_rows=rows[0], below_share=rows[0] / total)
    elif all(d < 0 for d in diff):
        out.update(where="above the largest point", crossover_rows=None, crossover_share=None,
                   above_rows=rows[-1], above_share=rows[-1] / total)
    else:
        i = next(i for i, d in enumerate(diff) if d >= 0)
        at = rows[i - 1] + (rows[i] - rows[i - 1]) * -diff[i - 1] / (diff[i] - diff[i - 1])
        out.update(where="between two points", crossover_rows=float(at), crossover_share=float(at / total))
    return out


def tiers_phase(dev, segments, record, fg, vsc, drive) -> None:
    """13. postings and the bit-sliced tier over phase 1's first 8
    lineitem segments (8 x 2^23 rows, x32): postings built and warmed at load, the postings
    ladders against the zone blocks and K1's full scan, the two bit-sliced
    queries against the scan tier, batched bit-sliced launches, and the
    bit-sliced programs against their byte bounds."""
    import warnings
    from concurrent.futures import ThreadPoolExecutor

    from pinot_tpu_torch.engine import bitsliced as bsl
    from pinot_tpu_torch.engine import config
    from pinot_tpu_torch.engine import device as device_mod
    from pinot_tpu_torch.engine import kernel as kernel_mod
    from pinot_tpu_torch.engine.context import TableContext
    from pinot_tpu_torch.engine.device import to_device_inputs
    from pinot_tpu_torch.engine.executor import QueryExecutor
    from pinot_tpu_torch.engine.invindex_path import index_path_decision
    from pinot_tpu_torch.engine.packing import stack_query_inputs
    from pinot_tpu_torch.engine.reduce import reduce_to_response
    from pinot_tpu_torch.pql import optimize_request, parse_pql
    from pinot_tpu_torch.segment import invindex as ii

    parse = lambda pql: optimize_request(parse_pql(pql))  # noqa: E731
    rec = record["tiers"] = {}
    segments = segments[:TIER_SEGMENTS]
    total = sum(s.num_docs for s in segments)
    S = len(segments)
    t_phase = time.perf_counter()

    # 13.1 postings built and warmed as a server loads its segments
    # (invertedIndexColumns), one thread a segment
    before = ii.postings_bytes_in_use()

    def warm(seg):
        t = time.perf_counter()
        ii.warm_inverted_indexes(seg, TIER_COLUMNS)
        return time.perf_counter() - t

    t = time.perf_counter()
    with ThreadPoolExecutor(max(1, min(S, os.cpu_count() or 1))) as pool:
        secs = list(pool.map(warm, segments))
    wall = time.perf_counter() - t
    by_col = {}
    for c in TIER_COLUMNS:
        idx = [s._inv_cache[c] for s in segments]
        if any(not isinstance(i, ii.InvertedIndex) for i in idx):
            raise AssertionError(f"postings for {c} were refused: {[type(i).__name__ for i in idx]}")
        kinds = np.bincount([b.kind for i in idx for b in (i.blocks or ())], minlength=3)
        by_col[c] = {"bytes": sum(i.nbytes for i in idx), "run_blocks": int(kinds[ii._RUN]),
                     "packed_blocks": int(kinds[ii._PACKED]), "raw_bytes": 4 * total}
    rec["postings_build"] = {"wall_s": wall, "s_per_segment": secs, "by_column": by_col,
                             "budget_bytes": ii._budget_bytes(),
                             "in_use_bytes": ii.postings_bytes_in_use() - before, "threads": pool._max_workers}
    log(f"tiers postings build: {wall:.1f} s wall over {S} segments in {pool._max_workers} threads, "
        f"{float(np.median(secs)):.3f} s a segment (median; {min(secs):.3f}-{max(secs):.3f}) for "
        f"{len(TIER_COLUMNS)} columns; by column {by_col}; {rec['postings_build']['in_use_bytes']} bytes of "
        f"the {ii._budget_bytes()}-byte budget")

    # 13.2 the postings ladders, each query three ways: the default route,
    # postings off (zone blocks on the sorted l_shipdate, a full scan on the
    # unsorted l_extendedprice), and postings and zone maps off (K1's full
    # scan); every answer equal to the full scan's
    col = segments[0].column("l_shipdate")
    step = col.dictionary.cardinality // max(TIER_DATES)
    ladder = {}
    for n in TIER_DATES:
        ids = [col.dictionary.index_of(ZONE_DATES[1])] if n == 1 else [i * step for i in range(n)]
        where = "l_shipdate IN ('" + "','".join(col.dictionary.get(i) for i in ids) + "')"
        ladder[f"dates_{n}"] = (_ZONE_SELECT.format(where=where), _share(col, ids))
    for share in TIER_PRICE_SHARES:
        where, held = _price_range(segments, share)
        ladder["price_needle" if not share else f"price_1/{round(1 / share)}"] = (_ZONE_SELECT.format(where=where),
                                                                                  held)
    tex = QueryExecutor(device=dev, precision="x32")
    routes = {"default": (True, True), "blocks": (False, True), "full": (False, False)}
    answers: Dict[str, Dict[str, Any]] = {}
    rec["ladder"] = {}
    for route, (postings, zone_maps) in routes.items():
        tex.postings, tex.zone_maps = postings, zone_maps
        reqs = {k: parse(v[0]) for k, v in ladder.items()}
        need = {} if route == "default" else {k: ("k1",) for k in reqs}
        answers[route] = drive(f"tiers_{route}", reqs, segments, need, executor=tex)
        decisions = tex.metrics.timer("phase.tierDecision")
        for name, req in reqs.items():
            res = tex.execute(segments, req)
            before = decisions.count
            ms, _ = cuda_ms(lambda: reduce_to_response(req, [tex.execute(segments, req)]), TIER_ITERS)
            # the two tiers' decisions where both declined (host clock)
            took = decisions.samples()[-(decisions.count - before):] if decisions.count > before else []
            tiers = {k: v for k, v in res.cost.items() if k.startswith("segments")}
            rec["ladder"].setdefault(name, {"pql": ladder[name][0], "share": ladder[name][1]})[route] = dict(
                ms=ms, tier=res._served_tier, cost_tiers=tiers, matched=res.num_docs_scanned,
                entries_in_filter=res.num_entries_scanned_in_filter,
                tier_decision_ms=float(np.median(took)) if took else None,
                launches=record["paths"][f"tiers_{route}"]["launches"][name])
    # K1 at the ladders' shapes (a 16-date match table over the block table,
    # a price BETWEEN over the full scan), held against its plain version in
    # every tier; these launches are not the path's
    rec["k1"] = {}
    for name, (postings, zone_maps) in (("dates_16", (False, True)), ("price_1/80", (False, False))):
        tex.postings, tex.zone_maps = postings, zone_maps
        req = parse(ladder[name][0])
        rec["k1"][name] = dict(k1_captured(fg, f"tiers {name} {'blocks' if zone_maps else 'full scan'}",
                                           lambda: tex.execute(segments, req)),
                               route="blocks" if zone_maps else "full")
    tex.postings, tex.zone_maps = True, True
    for name in ladder:
        r = rec["ladder"][name]
        for route in ("default", "blocks"):
            check_response(answers[route][name], response_as_want(answers["full"][name]))
        if r["default"]["tier"] == "postings" and any(r["default"]["launches"].values()):
            raise AssertionError(f"tiers {name}: the postings route launched {r['default']['launches']}")
        log(f"tiers ladder {name} (about {r['share']:.3g} of the table, {r['full']['matched']} rows matched): "
            + "; ".join(f"{route} {r[route]['ms']:.3f} ms by {r[route]['tier']} {r[route]['cost_tiers']}, "
                        f"{r[route]['entries_in_filter']} entries in the filter, tier decisions "
                        + ("none (a tier served)" if r[route]["tier_decision_ms"] is None else
                           f"{r[route]['tier_decision_ms']:.4f} ms") for route in routes)
            + "; answers equal (counts exact, sums in the audit band)")
    price = [n for n in ladder if n.startswith("price_")]
    dates = [n for n in ladder if n.startswith("dates_")]
    cross = {}
    for label, names, other in (("unsorted_vs_full_scan", price, "full"), ("sorted_vs_blocks", dates, "blocks"),
                                ("sorted_vs_full_scan", dates, "full")):
        served = sorted((n for n in names if rec["ladder"][n]["default"]["tier"] == "postings"),
                        key=lambda n: rec["ladder"][n]["full"]["matched"])
        if not served:
            continue
        c = cross[label] = _crossover([rec["ladder"][n]["full"]["matched"] for n in served],
                                      [rec["ladder"][n]["default"]["ms"] for n in served],
                                      [rec["ladder"][n][other]["ms"] for n in served], total)
        at = (f"at {c['crossover_rows']:.0f} rows, {c['crossover_share']:.3g} of the table"
              if c["crossover_rows"] is not None else
              f"{c['where']} ({c.get('below_rows', c.get('above_rows'))} rows, "
              f"{c.get('below_share', c.get('above_share')):.3g} of the table)")
        log(f"tiers crossover {label}: postings take {c['ms_per_million_rows']:.3f} ms per million matched rows "
            f"(least squares); postings and {other} take the same time {at} (the model's crossover: 1/64 = "
            f"0.0156); points (rows, postings ms, {other} ms) {[(r, round(a, 3), round(b, 3)) for r, a, b in c['points']]}")
    rec["crossover"] = cross

    # 13.3 the bit-sliced tier: both decisions taken (postings declined
    # first), the answers exactly the scan tier's, the program against its
    # byte bound, its planes' staging, and the host syncs of one call
    ctx = TableContext(segments)
    bex = QueryExecutor(device=dev, precision="x32", bitsliced=False)
    captured: Dict[str, Any] = {}
    real_maker = bsl.make_packed_bitsliced_kernel

    def capturing(spec):
        k = real_maker(spec)

        class Capture:
            fetch = staticmethod(k.fetch)

            @staticmethod
            def dispatch(segs, q):
                captured["bsi"] = (spec, segs, q)
                return k.dispatch(segs, q)

        return Capture

    rec["bitsliced"] = {}
    staging_seen: Dict[str, dict] = {}
    bsl.make_packed_bitsliced_kernel = capturing
    try:
        bsi_answers = drive("tiers_bitsliced", {k: parse(v) for k, v in BSI_QUERIES.items()}, segments, {},
                            executor=tex)
    finally:
        bsl.make_packed_bitsliced_kernel = real_maker
    for name, pql in BSI_QUERIES.items():
        req = parse(pql)
        post, _ = index_path_decision(req, segments, ctx, total)
        decision, state = bsl.bitsliced_decision(req, segments, ctx, total)
        log(f"tiers {name}: postings {post}; bit-sliced {decision}")
        if post["taken"] or not decision["taken"]:
            raise AssertionError(f"tiers {name}: the bit-sliced tier does not serve it")
        res = tex.execute(segments, req)
        scan = bex.execute(segments, parse(pql))
        if res._served_tier != "bitsliced" or res.cost.get("segmentsBitsliced") != S:
            raise AssertionError(f"tiers {name}: served by {res._served_tier}, cost {res.cost}")
        got = [a.value for a in bsi_answers[name].aggregation_results]
        want = [a.value for a in reduce_to_response(req, [scan]).aggregation_results]
        if got != want:
            raise AssertionError(f"tiers {name}: bit-sliced {got} != scan {want}")
        spec, leaves, agg_descs, planes_total, filter_planes = state
        # the program's inputs as the tier hands them over: capture one call
        captured.clear()
        bsl.make_packed_bitsliced_kernel = capturing
        try:
            tex.execute(segments, req)
        finally:
            bsl.make_packed_bitsliced_kernel = real_maker
        _, segs_in, q_in = captured["bsi"]
        program = kernel_mod.make_single_segment_bitsliced_kernel(spec)
        packed = real_maker(spec)
        prog_ms, _ = cuda_ms(lambda: program(segs_in, q_in), TIER_ITERS)
        call_ms, _ = cuda_ms(lambda: packed(segs_in, q_in), TIER_ITERS)
        q_ms, _ = cuda_ms(lambda: reduce_to_response(req, [tex.execute(segments, req)]), TIER_ITERS)
        scan_ms, _ = cuda_ms(lambda: reduce_to_response(req, [bex.execute(segments, req)]), TIER_ITERS)
        n_words = int(segs_in[next(k for k in segs_in if k.startswith("p:"))].shape[-1])
        # the bound reads each staged plane once (a column's planes serve the
        # filter, min and max alike); beside it the plane reads the program
        # makes, planes_total (a plane per use)
        distinct = sum(t.numel() * 4 for k, t in segs_in.items() if k != "nd")
        bound = distinct / HBM_BYTES_PER_S * 1e3
        reads_bound = planes_total * n_words * 4 * S / HBM_BYTES_PER_S * 1e3
        # the scan it replaces: K1 launches of one scan-route run
        k1_before = fg.launches
        bex.execute(segments, req)
        scan_k1 = fg.launches - k1_before
        # staging of its planes: host encode, bytes, the upload (each
        # column's planes measured once over both queries)
        stage = {}
        n_pad = config.pad_docs(max(s_.num_docs for s_ in segments))
        cols_all = sorted({c for _, c, _, _ in spec[0]} | {c for c, _, _ in spec[3]})
        for col in cols_all + [f"{c}:value" for c, _ in spec[2]]:
            if col in staging_seen:
                stage[col] = staging_seen[col]
                continue
            base = col.split(":")[0]
            cols = [s.column(base) for s in segments]
            t = time.perf_counter()
            if col.endswith(":value"):
                width, vmins = device_mod.bsiv_value_spec(cols)
                host = device_mod._bsiv_planes(cols, S, n_pad, width, vmins, dev)
            else:
                host = device_mod._bsi_planes(cols, S, n_pad, device_mod.bsi_filter_width(cols), dev)
            enc_s = time.perf_counter() - t
            torch.cuda.synchronize()
            t = time.perf_counter()
            host.to(dev, non_blocking=True)
            torch.cuda.synchronize()
            stage[col] = staging_seen[col] = {"bytes": host.numel() * 4, "encode_s": enc_s,
                                              "h2d_s": time.perf_counter() - t}
            del host
        # host syncs in one warm call: the sync debugger flags every
        # synchronizing op; the packed fetch's event wait is the one by design
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                tex.execute(segments, req)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        # (the debugger's own "prototype feature" notice is not a sync)
        syncs = [str(w.message)[:120] for w in caught if "called a synchronizing" in str(w.message)]
        r = rec["bitsliced"][name] = dict(
            decision=decision, answers=got, query_ms=q_ms, scan_query_ms=scan_ms, scan_k1_launches=scan_k1,
            program_ms=prog_ms, packed_call_ms=call_ms, bound_ms=bound, bound_by="bytes",
            planes=planes_total, filter_planes=filter_planes, n_words=n_words,
            distinct_plane_bytes=distinct, plane_reads_bound_ms=reads_bound,
            staging=stage, sync_debug_warnings=syncs, fetch_event_waits=1,
            entries_in_filter=res.num_entries_scanned_in_filter, bytes_scanned=res.cost["bytesScanned"])
        log(f"tiers {name}: answers {got} equal the scan tier's exactly; query {q_ms:.3f} ms against the scan "
            f"tier's {scan_ms:.3f} ms ({scan_k1} K1 launches there); the program {prog_ms:.4f} ms, with the packed "
            f"fetch {call_ms:.4f} ms (bound {bound:.4f} ms by bytes: the staged planes read once, {distinct} B; "
            f"{bound / prog_ms:.3f} of the bound; a read a use, {planes_total} planes x {n_words} words x 4 B x {S} "
            f"segments, {reads_bound:.4f} ms); staging {stage}; {len(syncs)} synchronizing ops flagged in one "
            f"call {syncs[:3]} "
            f"besides the packed fetch's one event wait; numEntriesScannedInFilter "
            f"{r['entries_in_filter']}, bytesScanned {r['bytes_scanned']}")

    # 13.4 batched bit-sliced launches: bsi_count_sum at 8 IN literals, each
    # member torch.equal to its own solo launch, at B = 1, 4, 8
    base = BSI_QUERIES["bsi_count_sum"]
    members, spec = [], None
    for lits in BSI_BATCH_LITERALS:
        req = parse(base.replace("(5, 10, 15)", "(" + ", ".join(map(str, lits)) + ")"))
        _, state = bsl.bitsliced_decision(req, segments, ctx, total)
        if state is None or (spec is not None and state[0] != spec):
            raise AssertionError(f"tiers batched {lits}: not the same bit-sliced spec")
        spec = state[0]
        members.append(bsl._query_inputs(state[1], segments, S))
    captured.clear()
    bsl.make_packed_bitsliced_kernel = capturing
    try:
        tex.execute(segments, parse(base))
    finally:
        bsl.make_packed_bitsliced_kernel = real_maker
    _, segs_in, _ = captured["bsi"]
    program = kernel_mod.make_single_segment_bitsliced_kernel(spec)
    solo_q = [to_device_inputs(m, dev) for m in members]
    solo_out = [program(segs_in, q) for q in solo_q]
    # a member against one solo launch (the loop of B solo launches below
    # also times the host's back-to-back launch of B programs)
    one_ms, _ = cuda_ms(lambda: program(segs_in, solo_q[0]), TIER_ITERS)
    rec["batched"] = {}
    for B in BSI_BATCH_SIZES:
        qb = to_device_inputs(stack_query_inputs(members[:B]), dev)
        out = program(segs_in, qb)
        for b in range(B):
            for k, v in solo_out[b].items():
                if not torch.equal(out[k][b], v):
                    raise AssertionError(f"tiers batched B={B} member {b} {k}: differs from its solo launch")
        ms, _ = cuda_ms(lambda: program(segs_in, qb), TIER_ITERS)
        solo_ms, _ = cuda_ms(lambda: [program(segs_in, q) for q in solo_q[:B]], TIER_ITERS)
        rec["batched"][B] = {"ms": ms, "per_member_ms": ms / B, "solo_total_ms": solo_ms, "one_solo_ms": one_ms,
                             "member_over_one_solo": ms / B / one_ms}
        log(f"tiers batched bsi_count_sum B={B}: every member torch.equal to its solo launch; {ms:.4f} ms a "
            f"launch, {ms / B:.4f} ms a member, {ms / B / one_ms:.3f} of one solo launch ({one_ms:.4f} ms); {B} "
            f"solo launches {solo_ms:.4f} ms")
    tex.free_staging()
    bex.free_staging()
    torch.cuda.empty_cache()
    rec["wall_s"] = time.perf_counter() - t_phase

# ---------------------------------------------------------------------------
# 14. realtime ingestion: lineitem as a REALTIME table consumed from the
# port's TCP stream broker by two server processes, queried at watermarks
# ---------------------------------------------------------------------------

RT_PARTITIONS = 2
RT_SEGMENT_ROWS = 1 << 21  # rowsPerSegment (2^23, the offline cells' segment size, before phase 20; 2^22 before 21)
RT_PARTITION_ROWS = 3 * (1 << 20)  # 1.5 x 2^21 a partition: one sealed segment, one consuming of 2^20
RT_BLOCK = 1 << 16  # rows a produced columnar block (and a server's fetch: PINOT_TPU_INGEST_BATCH_ROWS)
RT_STAGES = (4, 2, 1)  # the watermarks: a quarter, a half and the whole of the data
RT_QUERIES = {"q1": Q1, "count_star": "SELECT count(*) FROM lineitem", "distinct_price": VALUE_QUERIES["distinct_price"]}
RT_NEED = {"q1": "k1", "count_star": None, "distinct_price": "k2"}
RT_ITERS = 10  # timed broker requests a query at each watermark, after one checked request (20 before phase 15)
RT_VISIBLE_S = 600.0  # from a stage's last produce to every row counted
# the count polls' period: each poll at a new watermark snapshots both
# consuming segments (200-370 ms of host remap at 2^22 rows), which takes
# the server process's interpreter from its consumer
RT_POLL_S = 0.25
RT_EVENT_COLUMN = "l_eventms"  # the realtime schema's time column: each block's produce time (ms)


def head_segment(seg, n: int):
    """The first ``n`` rows of ``seg`` (its dictionaries kept): the rows of
    a partition produced so far, for the oracles."""
    from pinot_tpu_torch.segment.immutable import ColumnData, ImmutableSegment, SegmentMetadata

    cols = {c: ColumnData(metadata=col.metadata, dictionary=col.dictionary, fwd=col.fwd[:n])
            for c, col in seg.columns.items()}
    return ImmutableSegment(metadata=SegmentMetadata(segment_name=f"{seg.segment_name}_head{n}",
                                                     table_name=seg.metadata.table_name, num_docs=n), columns=cols)


def value_columns(seg) -> Dict[str, np.ndarray]:
    """A segment's rows as one value array a column, as a producer sends
    them (strings as fixed-width ``str``, numbers as float64)."""
    out = {}
    for c, col in seg.columns.items():
        d = col.dictionary
        vals = np.asarray(list(d.values)) if d.is_string else np.asarray(d.values, dtype=np.float64)
        out[c] = vals[col.fwd]
    return out


def rt_check(name: str, d: dict, wants: dict) -> None:
    """A broker reply at a watermark against the oracle over the rows
    produced so far: counts, groups and distinct values exact, sums in the
    audit band, served by the device."""
    resp = response_from_json(d)
    if resp.exceptions or resp.cost.get("segmentsHost"):
        raise AssertionError(f"realtime {name}: {d['exceptions']} {resp.cost}")
    if name == "q1":
        check_response(resp, wants["q1"])
    elif name == "count_star":
        if int(resp.aggregation_results[0].value) != wants["count_star"]:
            raise AssertionError(f"realtime count_star: {resp.aggregation_results[0].value} != "
                                 f"{wants['count_star']}")
    else:
        check_value_response(resp, wants[name])


def realtime_phase(dev, record, fg, vsc, hll_mod) -> None:
    """14. lineitem as a REALTIME table (replication 1, two stream
    partitions of a columnar topic on the port's StreamBrokerServer,
    rowsPerSegment 2^21), a controller, two server processes running
    RemoteConsumers and the broker: produced to a quarter, a half and the
    whole of 1.5 x 2^21 rows a partition, the queries at each watermark
    against the oracles over the rows produced so far; then K1 and K2 at a
    server's final shape (its sealed segment and its consuming snapshot)
    against their plain versions.  Each produced block carries its
    produce time as the event time (``l_eventms``, the schema's time
    column), so every broker answer carries ``freshnessMs``, held against
    the watermark the produced events give (phase 18 (b))."""
    import dataclasses

    from pinot_tpu_torch.common.schema import DataType, TimeFieldSpec
    from pinot_tpu_torch.common.tableconfig import StreamConfig, TableConfig
    from pinot_tpu_torch.engine.executor import QueryExecutor
    from pinot_tpu_torch.engine.reduce import reduce_to_response
    from pinot_tpu_torch.pql import optimize_request, parse_pql
    from pinot_tpu_torch.realtime.llc import make_segment_name
    from pinot_tpu_torch.realtime.mutable import MutableSegment
    from pinot_tpu_torch.realtime.netstream import NetworkStreamProvider, StreamBrokerServer
    from pinot_tpu_torch.segment.format import SEGMENT_FILE_NAME, read_segment
    from pinot_tpu_torch.tools.datagen import lineitem_schema, synthetic_lineitem_segment

    rec = record["realtime"] = {"card": card_line(), "stages": {}}
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="pinot-realtime-")
    t = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(RT_PARTITIONS) as pool:
        sources = list(pool.map(lambda p: synthetic_lineitem_segment(RT_PARTITION_ROWS, seed=101 + p,
                                                                     name=f"rt{p}"), range(RT_PARTITIONS)))
        columns = list(pool.map(value_columns, sources))
    log(f"realtime: {RT_PARTITIONS} partitions x {RT_PARTITION_ROWS} rows made in {time.perf_counter() - t:.1f} s "
        f"({sum(a.nbytes for c in columns for a in c.values())} bytes of columns)")
    # partition 0's consuming rows as an in-process mutable segment, for
    # K1 and K2 at its final shape; built while the roles start, joined
    # before the first produce
    indexer = concurrent.futures.ThreadPoolExecutor(1)

    def consuming_of_partition0():
        m = MutableSegment(lineitem_schema(), make_segment_name(physical, 0, 1), physical)
        for lo in range(RT_SEGMENT_ROWS, RT_PARTITION_ROWS, RT_BLOCK):
            m.index_columns({c: a[lo:lo + RT_BLOCK] for c, a in columns[0].items()})
        return m

    physical = "lineitem_REALTIME"
    stream = StreamBrokerServer()
    stream.start()
    try:
        building = indexer.submit(consuming_of_partition0)
        host, port = stream.address
        producers = [NetworkStreamProvider(host, port, "lineitem") for _ in range(RT_PARTITIONS)]
        producers[0].create_topic(RT_PARTITIONS)
        url, admin, broker_url, alive = start_roles(tmp, rec, server_env={"PINOT_TPU_INGEST_BATCH_ROWS": str(RT_BLOCK)})
        # lineitem with an event-time column, the produce time of its block
        rt_schema = dataclasses.replace(lineitem_schema(), time_field=TimeFieldSpec(
            RT_EVENT_COLUMN, DataType.LONG, time_unit="MILLISECONDS"))
        http_json(url + "/schemas", json.dumps(rt_schema.to_json()).encode())
        config = TableConfig("lineitem", table_type="REALTIME", stream=StreamConfig(
            stream_type="network", topic="lineitem", rows_per_segment=RT_SEGMENT_ROWS,
            properties={"host": host, "port": port}))
        http_json(url + "/tables", json.dumps(config.to_json()).encode())
        mutable = building.result()

        def launches():
            out = {"k1": 0, "k2": 0}
            for a in admin.values():
                got = http_json(a + "/debug/metrics")["kernelLaunches"]
                out = {k: out[k] + got[k] for k in out}
            return out

        def samples(timer: str, last: int = 0) -> Dict[str, List[float]]:
            return {n: http_json(f"{a}/debug/samples?timer={timer}&last={last}")["samples"] for n, a in admin.items()}

        def count() -> int:
            d = http_json(broker_url + "/query", json.dumps({"pql": RT_QUERIES["count_star"]}).encode())
            return int(response_from_json(d).aggregation_results[0].value) if not d["exceptions"] else -1

        per_query, totals = {}, {"k1": 0, "k2": 0}
        done = 0
        block_event = [{} for _ in range(RT_PARTITIONS)]  # ms: each produced block's event time, by first row
        freshness = rec["freshness_ms"] = {}
        for share in RT_STAGES:
            target = RT_PARTITION_ROWS // share
            label = f"1/{share}" if share > 1 else "all"
            st = rec["stages"][label] = {"rows_per_partition": target}
            t0 = time.perf_counter()

            def produce(p):
                for lo in range(done, target, RT_BLOCK):
                    block = {c: a[lo:lo + RT_BLOCK] for c, a in columns[p].items()}
                    block_event[p][lo] = int(time.time() * 1e3)
                    block[RT_EVENT_COLUMN] = np.full(len(block["l_quantity"]), block_event[p][lo], dtype=np.int64)
                    producers[p].produce_columns(block, partition=p)
                return time.perf_counter()

            with concurrent.futures.ThreadPoolExecutor(RT_PARTITIONS) as pool:
                produced_at = max(pool.map(produce, range(RT_PARTITIONS)))
            polls = 0
            end = time.monotonic() + RT_VISIBLE_S
            while True:
                alive()
                polls += 1
                if count() == RT_PARTITIONS * target:
                    break
                if time.monotonic() > end:
                    raise AssertionError(f"realtime {label}: rows not visible in {RT_VISIBLE_S} s")
                time.sleep(RT_POLL_S)
            visible_at = time.perf_counter()
            st.update(produce_s=produced_at - t0, ingest_rows_per_s_per_partition=(target - done) / (visible_at - t0),
                      produce_to_visible_ms=(visible_at - produced_at) * 1e3, count_polls=polls,
                      snapshot_ms={n: v[-1] if v else None for n, v in samples("phase.snapshot", 1).items()})
            log(f"realtime {label}: {target - done} rows a partition produced in {st['produce_s']:.1f} s, all "
                f"counted {st['produce_to_visible_ms']:.1f} ms after the last produce_columns returned "
                f"({polls} count polls, each at its own watermark); ingest "
                f"{st['ingest_rows_per_s_per_partition']:.0f} rows/s a partition; the last snapshot ms by server "
                f"{st['snapshot_ms']}")
            done = target
            heads = [head_segment(s, target) for s in sources]
            wants = {"q1": oracle(heads, "q1"), "count_star": RT_PARTITIONS * target,
                     "distinct_price": value_oracle(hll_mod, heads, "distinct_price")}
            st["queries"] = {}
            high = min(ev[max(ev)] for ev in block_event)
            last_first = min(target, RT_SEGMENT_ROWS) - 1  # the first consumer's last row
            low = min(ev[last_first - last_first % RT_BLOCK] for ev in block_event)
            watermark = (low, high)
            for name, pql in RT_QUERIES.items():
                body = json.dumps({"pql": pql}).encode()
                before = launches()
                sent = time.time() * 1e3
                d = http_json(broker_url + "/query", body)
                freshness[f"{label}/{name}"] = check_freshness(f"{label} {name}", d, watermark, sent,
                                                               time.time() * 1e3)
                after = launches()
                rt_check(name, d, wants)
                got = {k: after[k] - before[k] for k in after}
                require_launch(f"realtime {label} {name}", got, RT_NEED[name])
                per_query[f"{label}/{name}"] = got
                totals = {k: totals[k] + got[k] for k in totals}
                staging = {n: v[-1] if v else None for n, v in samples("phase.staging", 1).items()}
                broker_ms = []
                for _ in range(RT_ITERS):
                    sent = time.time() * 1e3
                    d = http_json(broker_url + "/query", body)
                    check_freshness(f"{label} {name}", d, watermark, sent, time.time() * 1e3)
                    if d["exceptions"]:
                        raise AssertionError(f"realtime {label} {name}: {d['exceptions']}")
                    broker_ms.append(d["timeUsedMs"])
                rt_check(name, d, wants)
                q = st["queries"][name] = {"p50_ms": float(np.percentile(broker_ms, 50)),
                                           "p99_ms": float(np.percentile(broker_ms, 99)), "n": RT_ITERS,
                                           "first_staging_ms": staging, "launches": got}
                log(f"realtime {label} {name}: equal to the oracle over the rows produced; broker p50 "
                    f"{q['p50_ms']:.3f} ms, p99 {q['p99_ms']:.3f} ms over {RT_ITERS}; the first request's staging "
                    f"ms by server {staging}; launches {got}; freshnessMs {freshness[f'{label}/{name}']:.1f} "
                    f"(every answer's within 1 ms of now minus a watermark in {watermark})")
            if label == "1/2":
                # the controller SIGKILLed and restarted between the second
                # watermark and the third, whose produce crosses the commit
                # at 2^23 rows: the commit runs through the restarted one
                rec["restart"] = restart_controller(url, tmp, "realtime-restarted")
            status = {n: http_json(a + "/debug/metrics") for n, a in admin.items()}
            st["staged_bytes"] = {n: s_["stagedBytes"] for n, s_ in status.items()}
            st["staged_tables"] = {n: s_["stagedTables"] for n, s_ in status.items()}
            log(f"realtime {label}: staged bytes by server {st['staged_bytes']}, staged segment sets "
                f"{st['staged_tables']}")
            # one staged set a query shape, whatever the watermarks polled
            if any(v > len(RT_QUERIES) for v in st["staged_tables"].values()):
                raise AssertionError(f"realtime {label}: staged sets {st['staged_tables']} grow with the watermarks")
        record["paths"]["realtime"] = {"launches": per_query, "totals": totals}
        first, last = rec["stages"]["1/4"], rec["stages"]["all"]
        # bytes a row hosted stay put from the first watermark to the last
        for n in admin:
            ratio = (last["staged_bytes"][n] / last["rows_per_partition"]) / \
                (first["staged_bytes"][n] / first["rows_per_partition"])
            if ratio > 1.5:
                raise AssertionError(f"realtime: {n}'s staged bytes a row grew {ratio:.2f}x across the watermarks")

        # the commits: one a partition, at 2^23 rows
        ideal = http_json(f"{url}/tables/{physical}/idealstate")
        want_ideal = {make_segment_name(physical, p, s): st_ for p in range(RT_PARTITIONS)
                      for s, st_ in ((0, "ONLINE"), (1, "CONSUMING"))}
        if {s_: set(r.values()) for s_, r in ideal.items()} != {s_: {v} for s_, v in want_ideal.items()}:
            raise AssertionError(f"realtime: ideal state {ideal}")
        commit = rec["commit"] = {n: {k: samples(f"ingest.commit{k}Ms")[n] for k in ("Convert", "File", "Upload", "")}
                                  for n in admin}
        commit_loads = samples("segmentLoad")
        ctrl_metrics = http_json(url + "/debug/metrics")["controller"]
        ctrl_ms = ctrl_metrics["timers"].get("segmentCommitMs")
        rec["commit_load_ms"], rec["controller_commit"] = commit_loads, ctrl_ms
        commits = ctrl_metrics["meters"]["segmentCommits"]["count"]
        if commits != RT_PARTITIONS:
            raise AssertionError(f"realtime: {commits} commits through the restarted controller, not {RT_PARTITIONS}")
        rec["restart"]["commits_after"] = commits
        rec["restart"]["produce_to_visible_ms"] = rec["stages"]["all"]["produce_to_visible_ms"]
        log(f"realtime restart: both commits ran through the restarted controller (epoch "
            f"{rec['restart']['epoch_after']}); the whole's produce-to-visible across the restart "
            f"{rec['restart']['produce_to_visible_ms']:.1f} ms, every produced row counted once")
        log(f"realtime commits: by server convert / file / upload / all ms {commit}; the ONLINE transition's load "
            f"of the committed copy ms {commit_loads}; the controller's persistence {ctrl_ms}")
        alive()

        # K1 and K2 at partition 0's final shape, as its server holds it:
        # the sealed segment (the controller's committed file) and the
        # consuming snapshot
        os.makedirs(os.path.join(tmp, "sealed"))
        sealed_name = make_segment_name(physical, 0, 0)
        with urllib.request.urlopen(f"{url}/segments/{physical}/{sealed_name}/file", timeout=DEPLOY_REQUEST_S) as r:
            with open(os.path.join(tmp, "sealed", SEGMENT_FILE_NAME), "wb") as f:
                shutil.copyfileobj(r, f)
        sealed = read_segment(os.path.join(tmp, "sealed"))
        t = time.perf_counter()
        snap = mutable.snapshot()
        rec["in_process_snapshot_ms"] = (time.perf_counter() - t) * 1e3
        segs = [sealed, snap]
        ex = QueryExecutor(device=dev, precision="x32")
        heads = [head_segment(sources[0], RT_PARTITION_ROWS)]
        rec["k1"] = k1_captured(fg, "realtime q1 (sealed + consuming snapshot)",
                                lambda: ex.execute(segs, optimize_request(parse_pql(Q1))))
        check_response(reduce_to_response(optimize_request(parse_pql(Q1)),
                                          [ex.execute(segs, optimize_request(parse_pql(Q1)))]), oracle(heads, "q1"))
        captured: dict = {}
        restore = _capture(vsc, "value_state", captured, "k2")
        req = optimize_request(parse_pql(RT_QUERIES["distinct_price"]))
        try:
            res = ex.execute(segs, req)
        finally:
            vsc.value_state = restore
        check_value_response(reduce_to_response(req, [res]), value_oracle(hll_mod, heads, "distinct_price"))
        (mode, *rest), kw = captured["k2"]
        args = {**dict(zip(("num_docs", "values"), rest)), **kw}
        tiers = compare_k2_value(vsc, mode, args)
        k_ms, _ = cuda_ms(lambda: vsc.value_state(mode, **args), ITERS)
        p_ms, _ = cuda_ms(lambda: vsc.value_state_reference(mode, **args), 1, warmup=0)
        matched = int(vsc.value_state(mode, **args)[0])
        bound, bound_by, nbytes, ops = k2_bound(vsc, mode, args, matched)
        rec["k2"] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=bound_by, bytes=nbytes, operations=ops,
                         tiers=tiers, mode=mode, shape=list(args["values"].shape), matched=matched, max_abs_err=0.0,
                         num_docs=args["num_docs"].tolist())
        log(f"k2 realtime distinct_price (sealed + consuming snapshot, {mode}, values {list(args['values'].shape)}, "
            f"num_docs {rec['k2']['num_docs']}, {matched} rows matched): {k_ms:.4f} ms (bound {bound:.4f} ms by "
            f"{bound_by}: {nbytes} bytes; {bound / k_ms:.3f} of the bound), plain {p_ms:.4f} ms, bit-equal in tiers "
            f"{tiers}; the in-process snapshot of {snap.num_docs} rows {rec['in_process_snapshot_ms']:.1f} ms")
        # the phase's measurements in one line, beside the card they were taken on
        summary = {label: {"ingest_rows_per_s_per_partition": st["ingest_rows_per_s_per_partition"],
                           "produce_to_visible_ms": st["produce_to_visible_ms"], "snapshot_ms": st["snapshot_ms"],
                           "staging_ms": {q: v["first_staging_ms"] for q, v in st["queries"].items()},
                           "broker_p50_p99_ms": {q: [v["p50_ms"], v["p99_ms"]] for q, v in st["queries"].items()},
                           "staged_bytes": st["staged_bytes"]}
                   for label, st in rec["stages"].items()}
        summary.update(commit_ms=rec["commit"], commit_load_ms=rec["commit_load_ms"],
                       k1_ms_bound_ms=[rec["k1"]["ms"], rec["k1"]["bound_ms"]],
                       k2_ms_bound_ms=[rec["k2"]["ms"], rec["k2"]["bound_ms"]])
        log(f"realtime summary on {rec['card']}: {json.dumps(summary)}")
        ex.free_staging()
        del ex, segs, snap, sealed, mutable
        torch.cuda.empty_cache()
    finally:
        codes = _stop_roles()
        stream.stop()
        indexer.shutdown(wait=True)
        rec["exit_codes"] = codes
        shutil.rmtree(tmp, ignore_errors=True)
        log(f"realtime: every role stopped with SIGTERM, exit codes {codes}; phase {time.perf_counter() - t_phase:.1f} s")
    if any(codes.values()):
        raise AssertionError(f"realtime: a role did not exit cleanly {codes}")


# ---------------------------------------------------------------------------
# EXPLAIN over what the servers hold (phases 10, 11, 12 and 15): plain
# EXPLAIN moves nothing, its plan is the one executed, ANALYZE's actuals
# are the reply's cost
# ---------------------------------------------------------------------------

EXPLAIN_ITERS = 20  # plain EXPLAINs timed a query through the broker


def _server_marks(st: dict) -> dict:
    """What a plain EXPLAIN must leave unchanged on a server, off its
    ``status()`` (in process or ``/debug/metrics``)."""
    return {"kernelLaunches": st["kernelLaunches"], "laneDispatches": (st.get("lane") or {}).get("dispatches"),
            "stagedBytes": st["stagedBytes"], "allocatedBytes": st["memory"]["allocatedBytes"]}


def _answer(d: dict) -> dict:
    return {k: d.get(k) for k in ("aggregationResults", "selectionResults")}


def explain_checks(label: str, ask, status, queries: Dict[str, str], check=None) -> dict:
    """EXPLAIN, the query, EXPLAIN again and EXPLAIN ANALYZE of each query
    through a broker: ``ask(pql)`` returns the response JSON, ``status()``
    each server's status.  Plain EXPLAIN leaves every server's kernel
    launches, lane dispatches, staged bytes and allocated card bytes as
    they were; the tier counts it predicts are the executed cost's; each
    device node's plan digest is the one the server's lane then records
    (its compile entry counts the execution's launch); ANALYZE's
    ``actualCost`` is the reply's cost and its answer the query's
    (``check(name, d)`` holds both against an oracle).  Returns a record a
    query, with the broker's EXPLAIN ms (p50 of ``EXPLAIN_ITERS``)."""
    out = {}
    for name, pql in queries.items():
        before = {n: _server_marks(st) for n, st in status().items()}
        plan = ask("EXPLAIN " + pql)
        after = {n: _server_marks(st) for n, st in status().items()}
        if plan["exceptions"] or "explain" not in plan or "aggregationResults" in plan:
            raise AssertionError(f"{label} explain {name}: {plan}")
        if after != before:
            raise AssertionError(f"{label} explain {name}: plain EXPLAIN moved the servers {before} -> {after}")
        ex = plan["explain"]
        devices = {n["server"]: n["device"] for n in ex["servers"] if "device" in n}
        d = ask(pql)
        if d["exceptions"]:
            raise AssertionError(f"{label} {name}: {d['exceptions']}")
        if check is not None:
            check(name, d)
        executed = {k: v for k, v in d.get("cost", {}).items() if k.startswith("segments") and v}
        if executed != ex["tierCounts"]:
            raise AssertionError(f"{label} explain {name}: predicted tiers {ex['tierCounts']}, executed {executed}")
        again = ask("EXPLAIN " + pql)["explain"]
        for node in again["servers"]:
            was = devices.get(node["server"])
            if was is None:
                continue
            dev, comp = node["device"], node["device"]["compile"]
            if dev["planDigest"] != was["planDigest"] or comp["state"] != "warm" or \
                    comp["launches"] != was["compile"].get("launches", 0) + 1:
                raise AssertionError(f"{label} explain {name}: the lane did not record EXPLAIN's digest for the "
                                     f"execution: before {was}, after {dev}")
        an = ask("EXPLAIN ANALYZE " + pql)
        if an["exceptions"] or an["explain"]["actualCost"] != an.get("cost", {}) or \
                an["explain"]["actualDocsScanned"] != an["numDocsScanned"]:
            raise AssertionError(f"{label} explain analyze {name}: {an.get('explain')} against cost {an.get('cost')}")
        if check is not None:
            check(name, an)
        if _answer(an) != _answer(d):
            raise AssertionError(f"{label} explain analyze {name}: the answer differs from the query's")
        ms = [ask("EXPLAIN " + pql)["timeUsedMs"] for _ in range(EXPLAIN_ITERS)]
        out[name] = {"tiers": ex["tierCounts"], "devices": {n: {"planDigest": v["planDigest"],
                                                                "compile": v["compile"]["state"]}
                                                            for n, v in devices.items()},
                     "staged": {n["server"]: n["staged"]["residency"] for n in ex["servers"]},
                     "explain_p50_ms": float(np.percentile(ms, 50)), "explain_max_ms": float(max(ms))}
        log(f"{label} explain {name}: plain EXPLAIN moved nothing on the servers (launches, dispatches, staged and "
            f"allocated bytes); predicted tiers {ex['tierCounts']} = executed; device digests honest "
            f"{ {n: v['planDigest'] for n, v in devices.items()} }; ANALYZE actualCost = cost; broker EXPLAIN p50 "
            f"{out[name]['explain_p50_ms']:.3f} ms, max {out[name]['explain_max_ms']:.3f} over {EXPLAIN_ITERS}")
    return out


# ---------------------------------------------------------------------------
# 15. residency: the hot / warm / cold tiers of one server's staging at
# full size, the OOM heal by demotion, EXPLAIN ANALYZE on promoted tables
# ---------------------------------------------------------------------------

RES_QUERIES = ("q1", "distinct_price", "hll_groupby")  # three staged sets of different columns
RES_ROUNDS = 2  # round-robin rounds under the two-set cap


def _k_calls(fg, vsc):
    """Record every K1 / K2 wrapper call (the arguments) until the
    returned function restores the wrappers."""
    calls: List[tuple] = []
    real_k1, real_k2 = fg.fused_filtered_groupby_sums, vsc.value_state

    def k1(*a, **k):
        calls.append(("k1", a, k))
        return real_k1(*a, **k)

    def k2(*a, **k):
        calls.append(("k2", a, k))
        return real_k2(*a, **k)

    fg.fused_filtered_groupby_sums, vsc.value_state = k1, k2

    def restore():
        fg.fused_filtered_groupby_sums, vsc.value_state = real_k1, real_k2

    return calls, restore


def check_k_calls(fg, vsc, calls) -> float:
    """Each recorded K1 / K2 call against its plain version on the same
    card tensors (in the tier the path chose): K1's counts exact and sums
    in the audit band, K2 bit-equal.  Returns K1's largest sum error."""
    err = 0.0
    for kind, a, k in calls:
        if kind == "k1":
            names = ("filter_fwd", "match", "num_docs", "group_keys", "value_fwds", "value_dicts", "capacity")
            args = {**dict(zip(names, a)), **k}
            got, want = fg.fused_filtered_groupby_sums(**args), fg.fused_filtered_groupby_sums_reference(**args)
            if int(got[0]) != int(want[0]) or not torch.equal(got[1].cpu(), want[1].cpu()):
                raise AssertionError("K1 disagrees with its plain version (docs or counts)")
            for x, y in zip(got[2], want[2]):
                err = max(err, _close(x, y, AUDIT_RTOL, AUDIT_ATOL))
        else:
            (mode, *rest), kw = a, k
            args = {**dict(zip(("num_docs", "values"), rest)), **kw}
            got, (docs, holder) = vsc.value_state(mode, **args), vsc.value_state_reference(mode, **args)
            if int(got[0]) != int(docs) or got[1].dtype != holder.dtype or not torch.equal(got[1], holder):
                raise AssertionError(f"K2 ({mode}) disagrees with its plain version")
    return err


def residency_phase(dev, segments, record, fg, vsc, wants) -> None:
    """15. One server (the lineitem table, 16 x 2^23 rows, x32) behind the
    broker over TCP: q1, distinct_price and hll_groupby staged uncapped
    (fresh staging ms, each set's ledger bytes), then an HBM cap that holds
    two of the three sets and RES_ROUNDS round-robin rounds: every answer
    bit-equal to the uncapped one, K1 and K2 on each promoted table equal
    to their plain versions, the hot bytes within the cap after each
    query, each promotion's staging ms against the fresh staging and the
    device-to-host / host-to-device copies of each demotion and promotion
    (the card's rates); a host cap that spills the warm set to disk, then
    its reload; a real torch.cuda.OutOfMemoryError healed by demotion (the
    card filled with filler tensors until less than the warm set is free,
    then its query); EXPLAIN over the tiers and EXPLAIN ANALYZE with K1 /
    K2 held against their plain versions."""
    from pinot_tpu_torch.engine import executor as executor_mod
    from pinot_tpu_torch.engine import residency as residency_mod
    from pinot_tpu_torch.engine.reduce import reduce_to_response
    from pinot_tpu_torch.pql import optimize_request, parse_pql

    rec = record["residency"] = {"card": card_line(), "queries": {}, "rounds": []}
    t_phase = time.perf_counter()
    spool = tempfile.mkdtemp(prefix="pinot-residency-")
    pqls = {n: {**QUERIES, **VALUE_QUERIES}[n] for n in RES_QUERIES}
    reqs = {n: optimize_request(parse_pql(p)) for n, p in pqls.items()}
    fleet = _Fleet(dev, {"res0": segments}, residency_dir=spool)
    server = fleet.servers["res0"]
    ex, tiers = server.executor, server.executor.residency
    copies: Dict[str, List[Tuple[float, int]]] = {"d2h": [], "h2d": []}
    real_snap, real_restore = residency_mod.snapshot_staged, residency_mod.restore_staged

    def timed_snap(st):
        t = time.perf_counter()
        out = real_snap(st)
        copies["d2h"].append((time.perf_counter() - t, out[1]))
        return out

    def timed_restore(snap, device, precision):
        t = time.perf_counter()
        out = real_restore(snap, device, precision)
        copies["h2d"].append((time.perf_counter() - t, out.nbytes()))
        return out

    residency_mod.snapshot_staged, residency_mod.restore_staged = timed_snap, timed_restore
    fg.launches = vsc.launches = 0
    per_query: Dict[str, Dict[str, int]] = {}
    keys: Dict[str, Tuple] = {}

    def run(name: str, label: str, check_kernels: bool) -> dict:
        """One query on the server's executor: its answer (accounting
        stripped), its launches, whether it promoted, its staging ms."""
        before = dict(tiers.counters)
        k1, k2 = fg.launches, vsc.launches
        calls, restore = _k_calls(fg, vsc)
        try:
            res = ex.execute(segments, reqs[name])
        finally:
            restore()
        torch.cuda.synchronize()
        launches = {"k1": fg.launches - k1, "k2": vsc.launches - k2}
        per_query[f"{label}/{name}"] = launches
        if res._served_tier != "device" or res.cost.get("segmentsHost"):
            raise AssertionError(f"residency {label} {name}: served by the {res._served_tier} tier, cost {res.cost}")
        resp = reduce_to_response(reqs[name], [res])
        (check_response if name in QUERIES else check_value_response)(resp, wants[name])
        err = check_k_calls(fg, vsc, calls) if check_kernels else None
        return {"answer": _answer(resp.to_json()), "launches": launches,
                "promoted": tiers.counters["promotions"] - before["promotions"],
                "demoted": tiers.counters["demotions"] - before["demotions"],
                "staging_ms": server.metrics.timer("phase.staging").samples()[-1], "k1_err": err,
                "kernel_calls": [c[0] for c in calls]}

    filler: List[torch.Tensor] = []
    try:
        # uncapped: each set staged fresh, its bytes off the ledger
        for name in RES_QUERIES:
            staged_keys = set(ex._staged)
            bytes_before = ex.ledger.total_bytes()
            r = run(name, "uncapped", check_kernels=False)
            (keys[name],) = set(ex._staged) - staged_keys
            q = rec["queries"][name] = {"answer": r["answer"], "bytes": ex.ledger.total_bytes() - bytes_before,
                                        "fresh_staging_ms": r["staging_ms"], "promotions_ms": []}
            log(f"residency uncapped {name}: {q['bytes']} bytes staged fresh in {q['fresh_staging_ms']:.1f} ms "
                f"(phase.staging), launches {r['launches']}")
        total = sum(q["bytes"] for q in rec["queries"].values())
        cap = total - min(q["bytes"] for q in rec["queries"].values())
        rec["cap_bytes"] = tiers.hbm_cap_bytes = cap
        tiers.enforce()
        log(f"residency cap {cap} bytes (every two sets, not three: {total} in all); tiers "
            f"{ {n: tiers.state_of(k) for n, k in keys.items()} }")

        # the capped cycle: round-robin, answers bit-equal, kernels on the
        # promoted tables held against their plain versions
        for rnd in range(RES_ROUNDS):
            rr = {"promoted": [], "demoted": 0}
            for name in RES_QUERIES:
                promoting = tiers.state_of(keys[name]) != "hot"
                r = run(name, f"round{rnd}", check_kernels=promoting)
                if r["answer"] != rec["queries"][name]["answer"]:
                    raise AssertionError(f"residency round {rnd} {name}: the answer differs from the uncapped one")
                if tiers.hot_bytes() > cap or ex.ledger.total_bytes() > cap:
                    raise AssertionError(f"residency round {rnd} {name}: hot {tiers.hot_bytes()} / ledger "
                                         f"{ex.ledger.total_bytes()} bytes past the cap {cap}")
                if r["promoted"] != int(promoting):
                    raise AssertionError(f"residency round {rnd} {name}: {r['promoted']} promotions, expected "
                                         f"{int(promoting)}")
                rr["demoted"] += r["demoted"]
                if promoting:
                    (h2d_s, h2d_bytes), (d2h_s, d2h_bytes) = copies["h2d"][-1], copies["d2h"][-1]
                    p = {"staging_ms": r["staging_ms"], "h2d_ms": h2d_s * 1e3, "h2d_bytes": h2d_bytes,
                         "d2h_ms": d2h_s * 1e3, "d2h_bytes": d2h_bytes, "k1_max_abs_err": r["k1_err"],
                         "kernels_checked": r["kernel_calls"]}
                    rec["queries"][name]["promotions_ms"].append(p)
                    rr["promoted"].append(name)
                    log(f"residency round {rnd} {name}: promoted in {r['staging_ms']:.1f} ms (phase.staging; fresh "
                        f"staging {rec['queries'][name]['fresh_staging_ms']:.1f}), its copy {h2d_bytes} bytes "
                        f"{p['h2d_ms']:.1f} ms ({h2d_bytes / h2d_s / 1e9:.2f} GB/s); the demotion it forced "
                        f"{d2h_bytes} bytes {p['d2h_ms']:.1f} ms ({d2h_bytes / d2h_s / 1e9:.2f} GB/s); "
                        f"kernels {r['kernel_calls']} equal to their plain versions; answer bit-equal")
            if not rr["promoted"] or not rr["demoted"]:
                raise AssertionError(f"residency round {rnd}: no promotion or no demotion {rr}")
            rec["rounds"].append(rr)
        rec["counters"] = dict(tiers.counters)

        # cold: a host cap that spills the warm set, then its reload
        (warm,) = [n for n, k in keys.items() if tiers.state_of(k) == "warm"]
        tiers.host_cap_bytes = 1
        t = time.perf_counter()
        tiers.enforce()
        spill_s = time.perf_counter() - t
        tiers.host_cap_bytes = 0
        files = [os.path.join(spool, f) for f in os.listdir(spool) if f.endswith(".npz")]
        if tiers.state_of(keys[warm]) != "cold" or len(files) != 1:
            raise AssertionError(f"residency cold: {warm} is {tiers.state_of(keys[warm])}, spool {files}")
        file_bytes = os.path.getsize(files[0])
        loads = tiers.counters["coldLoads"]
        r = run(warm, "cold", check_kernels=True)
        if r["answer"] != rec["queries"][warm]["answer"] or tiers.counters["coldLoads"] != loads + 1:
            raise AssertionError(f"residency cold {warm}: reload {r}")
        rec["cold"] = {"query": warm, "spill_s": spill_s, "file_bytes": file_bytes, "reload_ms": r["staging_ms"],
                       "fresh_staging_ms": rec["queries"][warm]["fresh_staging_ms"]}
        log(f"residency cold {warm}: spilled {file_bytes} bytes to disk in {spill_s:.3f} s; reloaded and promoted "
            f"in {r['staging_ms']:.1f} ms (phase.staging; fresh staging "
            f"{rec['queries'][warm]['fresh_staging_ms']:.1f}); answer bit-equal, kernels equal to their plain versions")

        # a real OOM: no cap, two sets hot, the card filled until less than
        # the warm set is left for the allocator; its query OOMs while
        # promoting, the ladder demotes and the retry answers from the card
        tiers.hbm_cap_bytes = 0
        (third,) = [n for n, k in keys.items() if tiers.state_of(k) != "hot"]
        need = rec["queries"][third]["bytes"]
        # short of the set by half the smallest hot set: one demotion
        # makes room
        short = min(q["bytes"] for n, q in rec["queries"].items() if n != third) // 2
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        # fill the card to the last MiB, by allocation failures (what the
        # allocator can get, whatever the driver's free count says), twice:
        # blocks whose frees were deferred (stream events) come back between
        for _ in range(2):
            chunk = 1 << 30
            while chunk >= 1 << 20:
                try:
                    filler.append(torch.empty(chunk, dtype=torch.uint8, device=dev))
                except torch.cuda.OutOfMemoryError:
                    chunk //= 2
            gc.collect()
            torch.cuda.synchronize()
        stats = torch.cuda.memory_stats(dev)
        cached_free = torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
        log(f"residency oom fill: {sum(f.numel() for f in filler)} bytes of filler; the allocator's cached free "
            f"{cached_free} bytes (inactive split {stats.get('inactive_split_bytes.all.current')}), driver free "
            f"{torch.cuda.mem_get_info(dev)[0]}")
        # ... then give back need - short of it to the allocator's cache
        given = 0
        while given < need - short and filler:
            given += filler.pop().numel()
        if given > need - short:  # the allocator splits its cached block for the rest
            filler.append(torch.empty(given - (need - short), dtype=torch.uint8, device=dev))
            given = need - short
        free_before = torch.cuda.mem_get_info(dev)[0] + given
        seen: List[str] = []
        real_classify = executor_mod.classify_device_error

        def classify(e):
            seen.append(type(e).__name__)
            return real_classify(e)

        executor_mod.classify_device_error = classify
        heal0 = ex.healing_stats()
        pressure0 = tiers.counters["pressureDemotions"]
        t = time.perf_counter()
        try:
            r = run(third, "oom", check_kernels=False)
        finally:
            executor_mod.classify_device_error = real_classify
        oom_ms = (time.perf_counter() - t) * 1e3
        heal = ex.healing_stats()
        grew = {k: heal[k] - heal0[k] for k in ("resourceExhausted", "hostFailovers", "deviceRetries")}
        if "OutOfMemoryError" not in seen or grew["resourceExhausted"] < 1 or grew["hostFailovers"] != 0 \
                or tiers.counters["pressureDemotions"] <= pressure0:
            raise AssertionError(f"residency oom {third}: errors {seen}, heal {grew}, pressure demotions "
                                 f"{tiers.counters['pressureDemotions'] - pressure0}, promoted {r['promoted']}, "
                                 f"need {need}, given back {given}, filler {sum(f.numel() for f in filler)}, "
                                 f"driver free {torch.cuda.mem_get_info(dev)}, allocated "
                                 f"{torch.cuda.memory_allocated(dev)}, reserved {torch.cuda.memory_reserved(dev)}")
        if r["answer"] != rec["queries"][third]["answer"]:
            raise AssertionError(f"residency oom {third}: the answer differs from the uncapped one")
        rec["oom"] = {"query": third, "need_bytes": need, "free_bytes_before": free_before, "given_back": given,
                      "filler_bytes": sum(f.numel() for f in filler), "errors": seen, "heal": grew,
                      "pressure_demotions": tiers.counters["pressureDemotions"] - pressure0, "ms": oom_ms}
        log(f"residency oom {third}: {free_before} bytes free of the {need} it needs (the card filled with "
            f"{rec['oom']['filler_bytes']} bytes of filler, {given} given back); errors {seen}; healed on the card by "
            f"{rec['oom']['pressure_demotions']} pressure demotion(s), heal {grew}, {oom_ms:.1f} ms; answer bit-equal")
        filler.clear()
        torch.cuda.empty_cache()

        # EXPLAIN over what the server holds, and ANALYZE with K1 / K2
        # held against their plain versions
        def ask(pql):
            return fleet.broker.handle_pql(pql).to_json()

        def check(name, d):
            if _answer(d) != rec["queries"][name]["answer"]:
                raise AssertionError(f"residency explain {name}: the answer differs from the uncapped one")

        k1, k2 = fg.launches, vsc.launches
        rec["explain"] = explain_checks("residency", ask, lambda: {"res0": server.status()}, pqls, check)
        per_query["explain"] = {"k1": fg.launches - k1, "k2": vsc.launches - k2}
        for name in ("q1", "distinct_price"):
            calls, restore = _k_calls(fg, vsc)
            try:
                k1, k2 = fg.launches, vsc.launches
                d = ask("EXPLAIN ANALYZE " + pqls[name])
                per_query[f"analyze/{name}"] = {"k1": fg.launches - k1, "k2": vsc.launches - k2}
            finally:
                restore()
            check(name, d)
            need_k = "k1" if name == "q1" else "k2"
            if need_k not in [c[0] for c in calls]:
                raise AssertionError(f"residency analyze {name}: {need_k} did not launch")
            err = check_k_calls(fg, vsc, calls)
            rec["explain"][name]["analyze_kernels"] = {"calls": [c[0] for c in calls], "k1_max_abs_err": err}
            log(f"residency analyze {name}: kernels {[c[0] for c in calls]} equal to their plain versions "
                f"(K1 max_abs_err {err:.6g}); staged tiers {d['explain']['servers'][0]['staged']['residency']}")
        rec["transfers"] = ex.transfers.snapshot()
        h2d = [(s_, b) for s_, b in copies["h2d"]]
        d2h = [(s_, b) for s_, b in copies["d2h"]]
        rec["rates_gb_s"] = {"h2d": [b / s_ / 1e9 for s_, b in h2d], "d2h": [b / s_ / 1e9 for s_, b in d2h]}
        record["paths"]["residency"] = {"launches": per_query,
                                        "totals": {k: sum(v[k] for v in per_query.values()) for k in ("k1", "k2")}}
        summary = {"cap_bytes": cap, "set_bytes": {n: q["bytes"] for n, q in rec["queries"].items()},
                   "fresh_staging_ms": {n: q["fresh_staging_ms"] for n, q in rec["queries"].items()},
                   "promotion_staging_ms": {n: [p["staging_ms"] for p in q["promotions_ms"]]
                                            for n, q in rec["queries"].items()},
                   "h2d_gb_s": rec["rates_gb_s"]["h2d"], "d2h_gb_s": rec["rates_gb_s"]["d2h"],
                   "cold": rec["cold"], "oom_ms": rec["oom"]["ms"],
                   "explain_p50_ms": {n: v["explain_p50_ms"] for n, v in rec["explain"].items()},
                   "counters": rec["counters"]}
        log(f"residency summary on {rec['card']}: {json.dumps(summary)}")
    finally:
        residency_mod.snapshot_staged, residency_mod.restore_staged = real_snap, real_restore
        filler.clear()
        fleet.close()
        ex.free_staging()
        shutil.rmtree(spool, ignore_errors=True)
        torch.cuda.empty_cache()
        log(f"residency phase {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# 16. build and evolve: lineitem written as CSV and Avro files, built into
# segments by the admin CLI's BatchCreateSegments on a local pool and on
# remote build workers, pushed to a deployed cluster, then the table's
# schema grown under it
# ---------------------------------------------------------------------------

# the cuts the time limit forced (PERF.md section 4): 2 CSV files of 2^18
# rows, the first rows of phase 1's li0 and li1 (4 files of its 2^23 rows
# took 117-135 s on 4 workers: the reference's build path is host Python;
# 2^22 rows a file before phase 17, 2^21 before 18, 2^20 before 20, 2^19
# before 21)
BUILD_FILES = 2
BUILD_ROWS = 1 << 18  # rows a CSV file (~0.015 GB of text; 2^21 before phase 18, 2^20 before 20, 2^19 before 21)
BUILD_WORKERS = 4  # BatchCreateSegments -workers (the CSV files and the Avro file, one worker each)
BUILD_GROWN_ROWS = 1 << 18  # the grown-schema CSV file, with real values (2^21 before phase 17, 2^20 before 20, 2^19
# before 21)
BUILD_AVRO_ROWS = 1 << 17  # the Avro file (deflate): the reference's codec is pure Python (2^18 before phase 18)
BUILD_SEEDS = {"grown": 97, "avro": 89}  # the CSV files are phase 1's li0.. (seeds 11, 12, ..)
BUILD_CHUNK = 1 << 20  # rows a vectorized CSV write step
GROWN_FIELDS = {
    "dimensionFieldSpecs": [{"name": "l_newflag", "dataType": "STRING"},
                            {"name": "l_newtags", "dataType": "INT_ARRAY", "singleValueField": False}],
    "metricFieldSpecs": [{"name": "l_newmetric", "dataType": "DOUBLE"}],
}
NEW_FLAGS = ("A", "B", "C")  # the grown file's l_newflag values
NEW_TAGS = (3, 5, 8, 13, 21, 34, 55, 89)  # its l_newtags pool: 1..3 distinct tags a row
EVOLVE_QUERIES = {
    "newflag_groups": "SELECT count(*) FROM lineitem GROUP BY l_newflag TOP 10",
    "newmetric_sum": "SELECT sum(l_newmetric) FROM lineitem",
    "newflag_null": "SELECT count(*) FROM lineitem WHERE l_newflag = 'null'",
    "newflag_distinct": "SELECT distinctcount(l_newflag) FROM lineitem",
    "newtags_groups": "SELECT count(*) FROM lineitem GROUP BY l_newtags TOP 10",
}
BUILD_BASE_QUERIES = {"q1": Q1, "count_star": "SELECT count(*) FROM lineitem",
                      "distinct_price": VALUE_QUERIES["distinct_price"]}
# the kernel each query must launch on the servers: the ungrouped count and
# sum run the table kernel's torch-op reductions (phase 14's count(*) too)
BUILD_NEED = {"q1": "k1", "distinct_price": "k2", "newflag_groups": "k1", "newtags_groups": "k1",
              "newflag_distinct": "k2"}
# K1's fused route with a cardinality-1 group column, and K2 over it (in process)
EVOLVED_Q1 = ("SELECT sum(l_quantity), sum(l_extendedprice), sum(l_discount), count(*) FROM lineitem "
              "WHERE l_shipdate <= '1998-09-02' GROUP BY l_returnflag, l_newflag TOP 10")
EVOLVED_DISTINCT = "SELECT distinctcount(l_newflag) FROM lineitem"


def grown_schema_json() -> dict:
    from pinot_tpu_torch.tools.datagen import lineitem_schema

    d = lineitem_schema().to_json()
    for k, extra in GROWN_FIELDS.items():
        d[k] = d[k] + extra
    return d


def _cells(values) -> Tuple[np.ndarray, np.ndarray]:
    """A dictionary's CSV cell texts as a byte matrix and their lengths:
    strings as they are, numbers in ``repr`` (which parses back exactly)."""
    texts = [(v if isinstance(v, str) else repr(float(v))).encode() for v in values]
    lens = np.array([len(t) for t in texts], dtype=np.int64)
    mat = np.zeros((len(texts), int(lens.max())), dtype=np.uint8)
    for i, t in enumerate(texts):
        mat[i, :len(t)] = np.frombuffer(t, dtype=np.uint8)
    return mat, lens


def write_csv_columns(path: str, names: List[str], cols: List[Tuple[list, np.ndarray]]) -> int:
    """Rows given column by column as (dictionary values, ids) written as
    CSV with vectorized numpy: each chunk of rows is one byte buffer, each
    cell copied in byte k of every row at once.  Returns the file's bytes."""
    cells = [_cells(vals) for vals, _ in cols]
    n = cols[0][1].size
    with open(path, "wb") as f:
        f.write((",".join(names) + "\n").encode())
        for lo in range(0, n, BUILD_CHUNK):
            hi = min(n, lo + BUILD_CHUNK)
            ids = [c[1][lo:hi] for c in cols]
            lens = [L[i] for (_, L), i in zip(cells, ids)]
            starts = np.zeros(hi - lo + 1, dtype=np.int64)
            np.cumsum(sum(lens) + len(names), out=starts[1:])
            buf = np.full(int(starts[-1]), ord(","), dtype=np.uint8)
            buf[starts[1:] - 1] = ord("\n")
            pos = starts[:-1].copy()
            for (mat, L), i, ln in zip(cells, ids, lens):
                shortest = int(L.min())
                for k in range(mat.shape[1]):
                    if k < shortest:
                        buf[pos + k] = mat[i, k]
                    else:
                        m = ln > k
                        buf[pos[m] + k] = mat[i[m], k]
                pos += ln + 1
            f.write(buf.tobytes())
    return os.path.getsize(path)


def build_source(kind: str, index: int, rows: int):
    """The rows of one input file, from seeds: a ``csv`` file is the first
    ``rows`` rows of phase 1's segment li<index> (its dictionaries and
    forward index), ``grown`` adds the three new columns with real values
    to lineitem at its own seed, ``avro`` is lineitem at its own seed.
    (segment, {new column: (dictionary values, ids)})."""
    from pinot_tpu_torch.tools.datagen import synthetic_lineitem_segment

    if kind == "csv":  # the head of phase 1's segment (its dictionaries kept)
        return head_segment(synthetic_lineitem_segment(ROWS_PER_SEGMENT, seed=11 + index, name=f"li{index}"),
                            rows), {}
    seg = synthetic_lineitem_segment(rows, seed=BUILD_SEEDS[kind], name=kind)
    if kind == "avro":
        return seg, {}
    rng = np.random.default_rng(BUILD_SEEDS[kind] + 1)
    flags = rng.integers(0, len(NEW_FLAGS), size=rows)
    metric_vals = np.round(np.arange(0.0, 100.0, 0.25), 2)
    metric = rng.integers(0, metric_vals.size, size=rows)
    # a row's tags: 1..3 consecutive pool entries from a start, so distinct
    start = rng.integers(0, len(NEW_TAGS), size=rows)
    count = rng.integers(1, 4, size=rows)
    combos = [";".join(str(NEW_TAGS[(s + j) % len(NEW_TAGS)]) for j in range(c))
              for s in range(len(NEW_TAGS)) for c in range(1, 4)]
    return seg, {"l_newflag": (list(NEW_FLAGS), flags), "l_newtags": (combos, start * 3 + count - 1),
                 "l_newmetric": (list(metric_vals), metric)}


def source_arrays(kind: str, index: int, rows: int) -> Dict[str, Any]:
    """The file's rows as the arrays ``build_segment_from_columns`` takes:
    SV columns one typed array (object for strings), the MV column (flat
    values, offsets)."""
    seg, extra = build_source(kind, index, rows)
    out = {}
    for name, col in seg.columns.items():
        d = col.dictionary
        out[name] = (np.asarray(d.values, dtype=object) if d.is_string else np.asarray(d.values))[col.fwd]
    for name, (vals, ids) in extra.items():
        if name == "l_newtags":  # ids = start * 3 + count - 1 (build_source)
            start, count = ids // 3, ids % 3 + 1
            offsets = np.zeros(rows + 1, dtype=np.int64)
            np.cumsum(count, out=offsets[1:])
            j = np.arange(3)
            tags = np.asarray(NEW_TAGS, dtype=np.int32)[(start[:, None] + j[None, :]) % len(NEW_TAGS)]
            out[name] = (tags[j[None, :] < count[:, None]], offsets)
        elif name == "l_newflag":
            out[name] = np.asarray(vals, dtype=object)[ids]
        else:
            out[name] = np.asarray(vals, dtype=np.float64)[ids]
    return out


def write_build_file(kind: str, index: int, rows: int, path: str) -> dict:
    """A spawned worker's task: one input file, written from its seeds."""
    t = time.perf_counter()
    seg, extra = build_source(kind, index, rows)
    gen_s = time.perf_counter() - t
    t = time.perf_counter()
    if kind == "avro":
        from pinot_tpu_torch.segment.avro import pinot_to_avro_schema, write_avro
        from pinot_tpu_torch.tools.datagen import lineitem_schema

        schema = lineitem_schema()
        vals = {n: (list(c.dictionary.values) if c.dictionary.is_string
                    else np.asarray(c.dictionary.values, dtype=np.float64).tolist())
                for n, c in seg.columns.items()}
        names = list(vals)
        cols = [[vals[n][i] for i in seg.column(n).fwd.tolist()] for n in names]
        records = [dict(zip(names, r)) for r in zip(*cols)]
        write_avro(path, pinot_to_avro_schema(schema), records, codec="deflate")
        size = os.path.getsize(path)
    else:
        names = [f.name for f in grown_or_base(kind)]
        cols = [(list(seg.column(n).dictionary.values), seg.column(n).fwd) if n in seg.columns else extra[n]
                for n in names]
        size = write_csv_columns(path, names, cols)
    return {"kind": kind, "index": index, "rows": rows, "path": path, "bytes": size, "gen_s": gen_s,
            "write_s": time.perf_counter() - t}


def grown_or_base(kind: str):
    from pinot_tpu_torch.common.schema import Schema
    from pinot_tpu_torch.tools.datagen import lineitem_schema

    return (Schema.from_json(grown_schema_json()) if kind == "grown" else lineitem_schema()).all_fields()


def oracle_build(kind: str, index: int, rows: int, path: str, stages: bool = False) -> dict:
    """A spawned worker's task: the segment a file must build into, and the
    build's stages timed apart.  A CSV: ``build_segment_from_columns`` over
    the SOURCE arrays the file was written from, then the segment file's
    write; with ``stages`` first the native parse and the cells'
    materialization of the file itself (the parsed arrays must equal the
    source arrays).  An Avro file: its decode by ``read_for_path`` and the
    row builder.  Returns the segment's CRC and the stage seconds."""
    from pinot_tpu_torch.common.schema import Schema
    from pinot_tpu_torch.segment import columnar, native
    from pinot_tpu_torch.segment.builder import build_segment
    from pinot_tpu_torch.segment.format import write_segment
    from pinot_tpu_torch.segment.readers import read_for_path
    from pinot_tpu_torch.tools.datagen import lineitem_schema

    schema = Schema.from_json(grown_schema_json()) if kind == "grown" else lineitem_schema()
    out = {"kind": kind, "index": index, "rows": rows}
    tmp = tempfile.mkdtemp(prefix="pinot-oracle-")
    try:
        if kind == "avro":
            t = time.perf_counter()
            rows_in = read_for_path(path, schema)
            out["decode_s"] = time.perf_counter() - t
            t = time.perf_counter()
            seg = build_segment(schema, rows_in, "lineitem_OFFLINE", "oracle")
            out["dict_fwd_s"] = time.perf_counter() - t
        elif stages:
            native.load()
            parse = []
            real = native.csv_parse

            def timed(*a, **k):
                t0 = time.perf_counter()
                try:
                    return real(*a, **k)
                finally:
                    parse.append(time.perf_counter() - t0)

            native.csv_parse = timed
            try:
                t = time.perf_counter()
                parsed, n = columnar.read_csv_columnar(path, schema)
                read_s = time.perf_counter() - t
            finally:
                native.csv_parse = real
            if parsed is None or n != rows:
                raise AssertionError(f"build {path}: the native parse did not take the file ({n} rows)")
            out["parse_s"], out["materialize_s"] = parse[0], read_s - parse[0]
            for name, want in source_arrays(kind, index, rows).items():
                got = parsed[name]
                same = all(np.array_equal(g, w) for g, w in zip(got, want)) if isinstance(want, tuple) \
                    else (got.dtype == want.dtype and np.array_equal(got, want))
                if not same:
                    raise AssertionError(f"build {path}: column {name} parsed back differs from its source")
            del parsed
        if kind != "avro":
            source = source_arrays(kind, index, rows)
            t = time.perf_counter()
            seg = columnar.build_segment_from_columns(schema, source, rows, "lineitem_OFFLINE", "oracle")
            out["dict_fwd_s"] = time.perf_counter() - t
        t = time.perf_counter()
        write_segment(seg, os.path.join(tmp, "seg"))
        out["write_s"] = time.perf_counter() - t
        out["crc"] = seg.metadata.crc
        out["file_bytes"] = os.path.getsize(os.path.join(tmp, "seg", os.listdir(os.path.join(tmp, "seg"))[0]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def _cpu_ticks(pid: int) -> int:
    """utime + stime of a process, in clock ticks (/proc/<pid>/stat)."""
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return int(fields[11]) + int(fields[12])


def _admin(args: List[str], timeout_s: float) -> Tuple[float, str]:
    """One admin CLI command as its own process: (wall seconds, stdout)."""
    env = dict(os.environ, PYTHONPATH=REPO_DIR + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "pinot_tpu_torch.tools.admin", *args], cwd=REPO_DIR, env=env,
                         capture_output=True, text=True, timeout=timeout_s)
    wall = time.perf_counter() - t
    if out.returncode != 0:
        raise AssertionError(f"admin {args[0]} exited {out.returncode}:\n{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    return wall, out.stdout


def _segment_crc(path: str) -> int:
    from pinot_tpu_torch.segment.format import read_segment_metadata

    with open(path, "rb") as f:
        return read_segment_metadata(f.read(), path).crc


def evolve_wants(hll_mod, old_segs, grown: Optional[dict]) -> Dict[str, Any]:
    """The oracles of phase 16's queries over the rows built before the
    schema grew (``old_segs``: the CSV-built and Avro-built rows, which
    take the default values) and the grown file's rows (``grown``: its
    segment and new columns, or None before it is pushed)."""
    segs = list(old_segs) + ([grown["segment"]] if grown else [])
    old_rows = sum(s.num_docs for s in old_segs)
    wants: Dict[str, Any] = {"q1": oracle(segs, "q1"), "count_star": sum(s.num_docs for s in segs),
                             "distinct_price": value_oracle(hll_mod, segs, "distinct_price")}
    flags = {("null",): {"count": old_rows}}
    tags = {(str(-(1 << 31)),): {"count": old_rows}}
    metric = 0.0
    if grown:
        fv, fid = grown["l_newflag"]
        for i, c in enumerate(np.bincount(fid, minlength=len(fv))):
            if c:
                flags[(fv[i],)] = {"count": int(c)}
        tv, tid = grown["l_newtags"]
        per_combo = np.bincount(tid, minlength=len(tv))
        acc: Dict[str, int] = {}
        for combo, c in zip(tv, per_combo):
            for t in combo.split(";"):
                acc[t] = acc.get(t, 0) + int(c)
        tags.update({(t,): {"count": c} for t, c in acc.items() if c})
        mv, mid = grown["l_newmetric"]
        metric = float(np.asarray(mv, dtype=np.float64)[mid].sum())
    wants.update(newflag_groups=flags, newtags_groups=tags, newmetric_sum=metric,
                 newflag_null=old_rows, newflag_distinct=len(flags))
    return wants


def check_evolved(name: str, d: dict, wants: dict) -> None:
    """A deployed reply of phase 16 against its oracle: counts, groups and
    distinct values exact, sums in the audit band, every row scanned,
    served by the device."""
    resp = response_from_json(d)
    if resp.exceptions or resp.cost.get("segmentsHost"):
        raise AssertionError(f"build {name}: {d['exceptions']} {resp.cost}")
    if name == "q1":
        check_response(resp, wants["q1"])
        return
    if name == "distinct_price":
        check_value_response(resp, wants["distinct_price"])
        return
    docs = wants["newflag_null"] if name == "newflag_null" else wants["count_star"]
    if d.get("numDocsScanned") != docs:
        raise AssertionError(f"build {name}: {d.get('numDocsScanned')} docs scanned, want {docs}")
    ar = resp.aggregation_results[0]
    if name in ("newflag_groups", "newtags_groups"):
        check_response(resp, wants[name])
    elif name == "newmetric_sum":
        if not math.isclose(float(ar.value), wants[name], rel_tol=AUDIT_RTOL, abs_tol=AUDIT_ATOL):
            raise AssertionError(f"build newmetric_sum: {ar.value} vs oracle {wants[name]}")
    elif int(ar.value) != wants[name]:
        raise AssertionError(f"build {name}: {ar.value} != oracle {wants[name]}")


def build_phase(dev, segments, record, fg, vsc, hll_mod, files: int = BUILD_FILES, rows: int = BUILD_ROWS,
                grown_rows: int = BUILD_GROWN_ROWS, avro_rows: int = BUILD_AVRO_ROWS,
                workers: int = BUILD_WORKERS) -> None:
    """16. The offline build path and schema evolution (module docstring).
    ``segments``: phase 1's lineitem segments; the CSV files are the first
    ``rows`` rows of the first ``files`` of them, and the in-process check
    runs over shallow copies of all of them.  On the CPU (a rehearsal at small
    sizes) the roles run with ``-device cpu`` and nothing counts launches."""
    from pinot_tpu_torch.common.schema import Schema
    from pinot_tpu_torch.common.tableconfig import TableConfig
    from pinot_tpu_torch.engine.reduce import reduce_to_response
    from pinot_tpu_torch.pql import optimize_request, parse_pql
    from pinot_tpu_torch.server.instance import ServerInstance
    from pinot_tpu_torch.tools.datagen import lineitem_schema

    on_card = dev.type == "cuda"
    rec = record["build"] = {"card": card_line() if on_card else "cpu"}
    tmp = tempfile.mkdtemp(prefix="pinot-build-")
    fdir = os.path.join(tmp, "files")
    os.makedirs(fdir)
    base_file = os.path.join(tmp, "lineitem.json")
    grown_file = os.path.join(tmp, "lineitem_grown.json")
    with open(base_file, "w") as f:
        json.dump(lineitem_schema().to_json(), f)
    with open(grown_file, "w") as f:
        json.dump(grown_schema_json(), f)
    # the local pool's inputs in the order its glob sorts them: the CSV files,
    # then the Avro file; the remote workers' input: the grown CSV file
    local_in = [("csv", i, rows, os.path.join(fdir, f"lineitem_{i}.csv")) for i in range(files)]
    local_in.append(("avro", 0, avro_rows, os.path.join(fdir, f"lineitem_{files}.avro")))
    grown_in = ("grown", 0, grown_rows, os.path.join(fdir, "grown.csv"))
    table = "lineitem_OFFLINE"
    t_phase = time.perf_counter()
    # the in-process step's q1 oracle over phase 1's segments, in a thread
    # beside the deployed steps
    q1_pool = concurrent.futures.ThreadPoolExecutor(1)
    q1_want = q1_pool.submit(oracle, segments, "q1")
    q1_pool.shutdown(wait=False)
    import multiprocessing

    # spawned, never forked: the workers never touch the card this process holds
    pool = concurrent.futures.ProcessPoolExecutor(max_workers=len(local_in) + 1,
                                                  mp_context=multiprocessing.get_context("spawn"))
    threads = concurrent.futures.ThreadPoolExecutor(2)
    try:
        # a. the files, in the pool's processes; the deployed roles and two
        # build workers start meanwhile
        t = time.perf_counter()
        written = {spec[3]: pool.submit(write_build_file, *spec) for spec in [grown_in] + local_in}
        roles = threads.submit(start_roles, tmp, rec, None, "cuda" if on_card else "cpu")
        build_workers = [_Role(f"buildworker{i}", ["StartBuildWorker", "-host", "127.0.0.1", "-port", "0"], tmp)
                         for i in range(2)]
        addrs = []
        for w in build_workers:
            end = time.monotonic() + DEPLOY_READY_S
            while not any(ln.startswith("build worker listening on ") for ln in w.tail(1 << 16).splitlines()):
                w.check_alive()
                if time.monotonic() > end:
                    raise AssertionError(f"{w.name}: not listening:\n{w.tail()}")
                time.sleep(0.1)
            line = next(ln for ln in w.tail(1 << 16).splitlines() if ln.startswith("build worker listening on "))
            addrs.append(line.rsplit(" ", 1)[1])

        # b. the remote pass as soon as its file is written: BatchCreateSegments
        # -remote-workers over the grown CSV file (no push yet: it joins the
        # table after the evolution), the worker holding it killed while it
        # builds and the shard retried on the other
        written[grown_in[3]].result()
        remote_oracle = pool.submit(oracle_build, *grown_in)

        def remote_run() -> dict:
            env = dict(os.environ, PYTHONPATH=REPO_DIR + os.pathsep + os.environ.get("PYTHONPATH", ""))
            t = time.perf_counter()
            coord = subprocess.Popen([sys.executable, "-m", "pinot_tpu_torch.tools.admin", "BatchCreateSegments",
                                      "-schema-file", grown_file, "-inputs", grown_in[3], "-table", table,
                                      "-out-dir", os.path.join(tmp, "built_remote"), "-remote-workers",
                                      ",".join(addrs), "-segment-name-prefix", "grown"],
                                     cwd=REPO_DIR, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            victim = build_workers[0].proc  # shard 0 is dealt to the first address
            base_ticks, half_s = _cpu_ticks(victim.pid), os.sysconf("SC_CLK_TCK") // 2
            while _cpu_ticks(victim.pid) - base_ticks < half_s and coord.poll() is None:
                time.sleep(0.05)  # until it has spent 0.5 s of CPU on the shard
            killed_after_s = time.perf_counter() - t
            mid_run = coord.poll() is None
            victim.kill()
            victim.wait(timeout=60)
            out, err = coord.communicate(timeout=1800)
            if coord.returncode != 0:
                raise AssertionError(f"build remote: BatchCreateSegments exited {coord.returncode}:\n{err[-4000:]}")
            return dict(out=out, wall_s=time.perf_counter() - t, killed_after_s=killed_after_s, mid_run=mid_run)

        remote = threads.submit(remote_run)
        url, admin, broker_url, alive = roles.result()
        rec["files"] = {os.path.basename(p): {k: w.result()[k] for k in ("rows", "bytes", "gen_s", "write_s")}
                        for p, w in written.items()}
        log(f"build: wrote {len(written)} files in {time.perf_counter() - t:.1f} s wall (vectorized numpy for the "
            f"CSV, the pure-Python codec for Avro, one spawned process each) beside the roles' start: "
            f"{json.dumps(rec['files'])}")
        http_json(url + "/schemas", json.dumps(lineitem_schema().to_json()).encode())
        http_json(url + "/tables", json.dumps(TableConfig("lineitem").to_json()).encode())

        # c. the local pool: BatchCreateSegments -workers builds the CSV files
        # (the columnar path) and the Avro file (the row builder) and pushes
        # them, while the pool builds each file's oracle segment (the first
        # CSV file's also times the parse and the materialization)
        oracles = [pool.submit(oracle_build, *spec, stages=spec[:2] == ("csv", 0)) for spec in local_in]
        wall, out = _admin(["BatchCreateSegments", "-schema-file", base_file, "-inputs",
                            os.path.join(fdir, "lineitem_*"), "-table", table, "-out-dir",
                            os.path.join(tmp, "built"), "-workers", str(workers), "-controller", url,
                            "-segment-name-prefix", "built"], timeout_s=1800)
        results = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
        oracles = [f.result() for f in oracles]
        if [(r["segment"], r["input"], r["docs"]) for r in results] != \
                [(f"built_{i}", spec[3], spec[2]) for i, spec in enumerate(local_in)] or \
                not all(r["pushed"] for r in results):
            raise AssertionError(f"build: BatchCreateSegments results {results}")
        for r, o in zip(results, oracles):
            crc = _segment_crc(r["path"])
            if crc != o["crc"]:
                raise AssertionError(f"build {r['segment']} ({o['kind']}): CRC {crc} != the oracle build's {o['crc']}")
        stages = {k: round(oracles[0][k], 3) for k in ("parse_s", "materialize_s", "dict_fwd_s", "write_s")}
        avro = {k: round(oracles[-1][k], 3) for k in ("decode_s", "dict_fwd_s", "write_s")}
        local_rows = rows * files + avro_rows
        rec["local"] = dict(wall_s=wall, workers=workers, files=len(local_in), rows=local_rows,
                            rows_per_s_per_worker=local_rows / wall / min(workers, len(local_in)), stages=stages,
                            csv_rows_per_s=rows / sum(stages.values()), avro_stages=avro,
                            avro_rows_per_s=avro_rows / sum(avro.values()),
                            dict_fwd_s=[o["dict_fwd_s"] for o in oracles])
        log(f"build local pool: BatchCreateSegments -workers {workers}, {files} CSV files of {rows} rows and the Avro "
            f"file of {avro_rows} built and pushed in {wall:.1f} s wall ({rec['local']['rows_per_s_per_worker']:.0f} "
            f"rows/s per worker); each CSV segment's CRC equal to build_segment_from_columns over the file's source "
            f"arrays, the Avro segment's to the row builder's; a CSV file's stages (native parse / cell "
            f"materialization / dictionary and forward index / file write, s) {stages}, "
            f"{rec['local']['csv_rows_per_s']:.0f} rows/s; the Avro file's (decode / row build / write) {avro}, "
            f"{rec['local']['avro_rows_per_s']:.0f} rows/s")

        # d. the deployed table against oracles of those rows
        online_s = wait_online(url, broker_url, table, len(local_in), alive)

        def launches():
            got = {"k1": 0, "k2": 0}
            if not on_card:
                return got
            for a in admin.values():
                k = http_json(a + "/debug/metrics")["kernelLaunches"]
                got = {n: got[n] + k[n] for n in got}
            return got

        avro_seg, _ = build_source("avro", 0, avro_rows)
        old_segs = [build_source("csv", i, rows)[0] for i in range(files)] + [avro_seg]
        per_query: Dict[str, Dict[str, int]] = {}

        def ask(label: str, pqls: Dict[str, str], wants: dict) -> None:
            for name, pql in pqls.items():
                before = launches()
                d = http_json(broker_url + "/query", json.dumps({"pql": pql}).encode())
                after = launches()
                check_evolved(name, d, wants)
                moved = {k: after[k] - before[k] for k in after}
                per_query[f"{label}/{name}"] = moved
                if on_card:
                    require_launch(f"build {label}/{name}", moved, BUILD_NEED.get(name))

        wants = evolve_wants(hll_mod, old_segs, None)
        ask("pushed", BUILD_BASE_QUERIES, wants)
        log(f"build: {len(local_in)} segments ONLINE {online_s:.1f} s after the last push; q1, count(*) and "
            f"distinct_price over the {wants['count_star']} rows equal their oracles")

        # e. the grown schema through AddSchema: the controller reloads the
        # table, each server patches its loaded segments on the CRC skip
        t = time.perf_counter()
        add_s, _ = _admin(["AddSchema", "-controller", url, "-schema-file", grown_file], timeout_s=300)
        end = time.monotonic() + DEPLOY_ONLINE_S
        while True:
            alive()
            d = http_json(broker_url + "/query", json.dumps({"pql": EVOLVE_QUERIES["newflag_groups"]}).encode())
            if not d["exceptions"] and d.get("numDocsScanned") == wants["count_star"]:
                break
            if time.monotonic() > end:
                raise AssertionError(f"build: the grown schema did not reach every server: {d}")
            time.sleep(0.05)
        reload_s = time.perf_counter() - t
        loads = {n: http_json(a + "/debug/metrics")["metrics"]["timers"]["segmentLoad"]["count"]
                 for n, a in admin.items()}
        if sum(loads.values()) != len(local_in):
            raise AssertionError(f"build: the reload loaded segments again {loads}")
        ask("evolved", EVOLVE_QUERIES, wants)
        rec["reload"] = dict(reload_s=reload_s, add_schema_process_s=add_s, segment_loads=loads)
        log(f"build: AddSchema of the grown schema to every server answering with the default columns "
            f"{reload_s:.3f} s (the AddSchema process {add_s:.3f} s of it), no segment loaded again {loads}; "
            f"the five evolved queries equal their oracles (one null group, sum 0.0, every row 'null', "
            f"distinctcount 1, the INT default -2^31)")

        # f. the remote pass's segment, then its push with UploadSegment
        rr = remote.result()
        if on_card and not rr["mid_run"]:
            raise AssertionError("build remote: the run ended before its first worker could be killed")
        (result,) = [json.loads(ln) for ln in rr["out"].splitlines() if ln.startswith("{")]
        oracle_grown = remote_oracle.result()
        if (result["segment"], result["docs"], result["pushed"]) != ("grown_0", grown_rows, False):
            raise AssertionError(f"build remote: result {result}")
        crc = _segment_crc(result["path"])
        if crc != oracle_grown["crc"]:
            raise AssertionError(f"build grown_0: CRC {crc} != build_segment_from_columns' {oracle_grown['crc']}")
        t = time.perf_counter()
        _admin(["UploadSegment", "-controller", url, "-table", table, "-segment-file", result["path"]], timeout_s=600)
        push_s = time.perf_counter() - t
        rec["remote"] = dict(wall_s=rr["wall_s"], killed_after_s=rr["killed_after_s"], killed_mid_run=rr["mid_run"],
                             rows=grown_rows, push_s=push_s, rows_per_s=grown_rows / rr["wall_s"],
                             stages={k: round(v, 3) for k, v in oracle_grown.items() if k.endswith("_s")})
        log(f"build remote (beside the local pool): BatchCreateSegments -remote-workers over two StartBuildWorker "
            f"processes, the one given the grown CSV file ({grown_rows} rows) killed {rr['killed_after_s']:.1f} s "
            f"into it (0.5 s of its CPU spent) and the shard retried on the other: built in {rr['wall_s']:.1f} s "
            f"wall ({rec['remote']['rows_per_s']:.0f} rows/s), its CRC equal to build_segment_from_columns'; "
            f"pushed with UploadSegment in {push_s:.1f} s; the oracle build's stages (s) {rec['remote']['stages']}")

        # g. the mixed-age table: old rows with defaults, new rows with values
        wait_online(url, broker_url, table, len(local_in) + 1, alive)
        grown_seg, extra = build_source("grown", 0, grown_rows)
        wants = evolve_wants(hll_mod, old_segs, dict(extra, segment=grown_seg))
        ask("mixed", {**BUILD_BASE_QUERIES, **EVOLVE_QUERIES}, wants)
        record["paths"]["build_deployed"] = {"launches": per_query, "totals": {
            k: sum(v[k] for v in per_query.values()) for k in ("k1", "k2")}}
        log(f"build: the mixed-age table ({wants['count_star']} rows: {files} CSV-built segments and the Avro-built "
            f"one with defaults, the grown file's with values) equal to its oracles; launches on the servers per "
            f"query {per_query}")
        alive()
    finally:
        codes = _stop_roles()  # first: a remote pass still running ends with its workers
        threads.shutdown(wait=True)
        pool.shutdown(wait=True, cancel_futures=True)
        rec["exit_codes"] = codes
        shutil.rmtree(tmp, ignore_errors=True)
        log(f"build: every role stopped with SIGTERM, exit codes {codes}; phase {time.perf_counter() - t_phase:.1f} s")
    if any(v for n, v in codes.items() if n != "buildworker0"):  # the killed worker exits -9
        raise AssertionError(f"build: a role did not exit cleanly {codes}")

    # h. K1 and K2 at the evolved shapes in process: the grown schema set on
    # a server over shallow copies of phase 1's segments (theirs untouched)
    import copy

    copies = []
    for s in segments:
        c = copy.copy(s)
        c.metadata = copy.copy(s.metadata)
        copies.append(c)
    server = ServerInstance("evolve", device=dev, precision="x32", pipeline=False)
    try:
        for c in copies:
            server.add_segment("lineitem_OFFLINE", c)
        server.set_table_schema("lineitem_OFFLINE", Schema.from_json(grown_schema_json()))
        if not all(c.has_column("l_newflag") for c in copies) or any(s.has_column("l_newflag") for s in segments):
            raise AssertionError("evolve: the copies were not patched, or phase 1's segments were")
        ex = server.executor
        q1_req, dc_req = optimize_request(parse_pql(EVOLVED_Q1)), optimize_request(parse_pql(EVOLVED_DISTINCT))
        fg.launches = 0
        vsc.launches = 0
        q1_resp = reduce_to_response(q1_req, [ex.execute(copies, q1_req)])
        after_q1 = {"k1": fg.launches, "k2": vsc.launches}
        dc_resp = reduce_to_response(dc_req, [ex.execute(copies, dc_req)])
        totals = {"k1": fg.launches, "k2": vsc.launches}
        record["paths"]["build_inprocess"] = {"totals": totals, "launches": {
            "evolved_q1": after_q1, "evolved_distinct": {k: totals[k] - after_q1[k] for k in totals}}}
        want_q1: Dict[Tuple[str, ...], Dict[str, Any]] = {}  # q1's oracle, l_linestatus folded into "null"
        for (rf, _ls), v in q1_want.result().items():
            e = want_q1.setdefault((rf, "null"), {k: 0 if k == "count" else 0.0 for k in v})
            for k in v:
                e[k] += v[k]
        check_response(q1_resp, want_q1)
        check_value_response(dc_resp, {(): 1})
        if on_card and (totals["k1"] < 1 or totals["k2"] < 1):
            raise AssertionError(f"evolve: launches {totals}")
        staged = 0
        for st in ex._staged.values():
            col = st.columns.get("l_newflag")
            if col is not None:
                staged = max(staged, sum(t.numel() * t.element_size() for t in col.tensors()))
        rec["default_column_staged_bytes"] = staged
        rec["inprocess_rows"] = sum(c.num_docs for c in copies)
        if on_card:
            rec["k1"] = k1_captured(fg, "evolved q1 (l_returnflag x the default l_newflag)",
                                    lambda: ex.execute(copies, q1_req))
            captured: dict = {}
            restore = _capture(vsc, "value_state", captured, "k2")
            try:
                ex.execute(copies, dc_req)
            finally:
                vsc.value_state = restore
            (mode, *rest), kw = captured["k2"]
            args = {**dict(zip(("num_docs", "values"), rest)), **kw}
            tiers = compare_k2_value(vsc, mode, args)
            k_ms, _ = cuda_ms(lambda: vsc.value_state(mode, **args), ITERS)
            p_ms, _ = cuda_ms(lambda: vsc.value_state_reference(mode, **args), 1, warmup=0)
            matched = int(vsc.value_state(mode, **args)[0])
            bound, bound_by, nbytes, ops = k2_bound(vsc, mode, args, matched)
            idx, K, _ = vsc.combine_index(mode, **args)
            lib_ms, _ = cuda_ms(lambda: torch.bincount(idx.reshape(-1), minlength=K + 1)[:K], ITERS)
            del idx
            rec["k2"] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=bound_by, bytes=nbytes,
                             operations=ops, tiers=tiers, mode=mode, K=K, shape=list(args["values"].shape),
                             matched=matched, library_ms=lib_ms, max_abs_err=0.0)
            log(f"k2 evolved distinctcount(l_newflag) ({mode}, K={K}, values {list(args['values'].shape)}, "
                f"{matched} rows matched): {k_ms:.4f} ms (bound {bound:.4f} ms by {bound_by}: {nbytes} bytes; "
                f"{bound / k_ms:.3f} of the bound), plain {p_ms:.4f} ms, torch.bincount {lib_ms:.4f} ms, bit-equal "
                f"in tiers {tiers}")
            del args
        log(f"evolve in process: the grown schema set on a server over {rec['inprocess_rows']} rows of phase 1's "
            f"segments (shallow copies): q1 by l_returnflag x l_newflag and distinctcount(l_newflag) equal their "
            f"oracles, launches {totals}; the default column staged {staged} bytes")
        ex.free_staging()
    finally:
        server.shutdown()
        del copies
        if on_card:
            torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 17. warm start and utilization: a deployed cluster with the compile cache
# on; the utilization planes read across the three roles; a torch.profiler
# capture; the occupancy sampler; a server killed and restarted three times
# ---------------------------------------------------------------------------

WARM_QUERIES = ("q1", "q3", "hll_groupby", "distinct_price", "pct_quantity")
WARM_NEED = {"q1": "k1", "q3": "k1", "hll_groupby": "k2", "distinct_price": "k2", "pct_quantity": "k2"}
# the restarted server hosts this many of the table's 16 segments (the
# other server the rest): a restart reloads them, ~3.6 s a segment (cut:
# the reload's length; the table stays 16 x 2^23 rows)
WARM_RESTART_SEGMENTS = 1
WARM_SEGMENTS = 8  # phase 1's first 8 segments, 7 on server0 (all 16 before phase 21)
WARM_ITERS = 3  # warm requests a digest after each restart's first, for the warm p50
WARM_BUSY_S = 1.0  # the query burst the occupancy sampler reads busy under (1.5 before the cuts of phase 17)
# the restarts in order: (label, cache root index, prewarm on, the compile
# state EXPLAIN must read before the first query)
WARM_RESTARTS = (("fresh", 1, False, "cold"), ("same root", 1, False, "persistent"),
                 ("prewarm", 1, True, "prewarmed"))


def seed_library_roots(roots: List[str]) -> None:
    """The kernels' libraries of the main build copied under each
    compile-cache root (``<root>/ext/<fingerprint>``, under the names the
    servers look for): phase 17's servers then start without nvcc, and its
    restarts measure the first query, not the build (the build line's
    seconds are what a root without them pays at a server's start).  The
    same source, flags and toolkit build the same library, so the copy
    stands for a build."""
    from pinot_tpu_torch.engine import compilecache, kernels

    for root in roots:
        dst = compilecache.library_dir(root)
        os.makedirs(dst, exist_ok=True)
        for name in kernels.KERNELS:
            src = kernels.library_path(name)
            shutil.copy2(src, os.path.join(dst, src.name))


def capture_kernels(kern: Dict[str, Any]) -> Tuple[List[str], List[str]]:
    """K1's and K2's kernel names in a capture's device-kernel summary;
    raises unless both are there."""
    k1 = sorted(k for k in kern if "fused_groupby" in k)
    k2 = sorted(k for k in kern if "value_state_kernel" in k)
    if not k1 or not k2:
        raise AssertionError(f"warm start (c): the capture lacks K1 or K2 by name: {sorted(kern)}")
    return k1, k2


def launch_bytes(fg, vsc, ex, segs, req) -> Dict[str, int]:
    """``data_bound``'s bytes of the K1 / K2 launches one in-process run of
    ``req`` over ``segs`` makes (each wrapper's last launch, captured)."""
    captured: dict = {}
    r1 = _capture(fg, "fused_filtered_groupby_sums", captured, "k1")
    r2 = _capture(vsc, "value_state", captured, "k2")
    try:
        ex.execute(segs, req)
    finally:
        fg.fused_filtered_groupby_sums = r1
        vsc.value_state = r2
    out = {}
    if "k1" in captured:
        names = ("filter_fwd", "match", "num_docs", "group_keys", "value_fwds", "value_dicts", "capacity")
        a, k = captured["k1"]
        args = {**dict(zip(names, a)), **k}
        args.setdefault("filter_bounds", None)
        args.setdefault("group_cols", None)
        matched = int(fg.fused_filtered_groupby_sums(**args)[0])
        out["k1"] = k1_bound(args, matched)[2]
    if "k2" in captured:
        (mode, *rest), kw = captured["k2"]
        args = {**dict(zip(("num_docs", "values"), rest)), **kw}
        matched = int(vsc.value_state(mode, **args)[0])
        out["k2"] = k2_bound(vsc, mode, args, matched)[2]
    return out


# ---------------------------------------------------------------------------
# 19. the controller: its durable state through a SIGKILL and a restart,
# a drain and a rebalance under a query loop, its pages and CLI
# ---------------------------------------------------------------------------

CTRL_QUERIES = ("q1", "q3", "hll_groupby", "distinct_price")
CTRL_NEED = {"q1": "k1", "q3": "k1", "hll_groupby": "k2", "distinct_price": "k2"}
CTRL_WAIT_S = 600.0  # a drain, a rebalance, a restarted controller's refill
CTRL_PAGES = ("/", "/dashboard/query", "/dashboard/table/lineitem_OFFLINE", "/dashboard/metrics",
              "/dashboard/capacity", "/dashboard/workload", "/dashboard/utilization", "/dashboard/slo")
CTRL_STABILIZER_KEYS = {"graceSeconds", "deadTracked", "rebalance", "events", "metrics"}


def _alive_roles() -> None:
    """Raise when a deployed role of now (a controller, a server, the
    broker; a role killed on purpose has left ``_ROLES``) has exited."""
    for role in list(_ROLES):
        if role.name.startswith(("controller", "server", "broker")):
            role.check_alive()


def _journal_bytes(data_dir: str) -> int:
    d = os.path.join(data_dir, "property_store", ".journal")
    return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)) if os.path.isdir(d) else 0


def restart_controller(url: str, tmp: str, label: str) -> dict:
    """SIGKILL the phase's controller process and start a new one on the
    same ``-data-dir`` and port: (READY s, the recovery's ms, both epochs,
    the journal's bytes when it was killed).  The servers' heartbeats are
    told to register again and the broker's poll moves to the new epoch."""
    role = next(r for r in _ROLES if r.name.startswith("controller"))
    data_dir = os.path.join(tmp, "controller")
    old_epoch = int(http_json(url + "/clusterstate?ifNewer=-1")["epoch"])
    journal = _journal_bytes(data_dir)
    role.proc.kill()
    role.proc.wait(timeout=60)
    _ROLES.remove(role)
    role.log.close()
    port = url.rsplit(":", 1)[1]
    t = time.perf_counter()
    new = _Role(f"controller-{label}", ["StartController", "-port", port, "-data-dir", data_dir,
                                        "-heartbeat-timeout", "60", "-device", DEPLOY_DEVICE], tmp)
    words = new.ready(DEPLOY_READY_S)
    ready_s = time.perf_counter() - t
    if words[2] != url:
        raise AssertionError(f"{label}: the restarted controller serves {words[2]}, not {url}")
    gauges = http_json(url + "/debug/metrics")["controller"]["gauges"]
    epoch = int(http_json(url + "/clusterstate?ifNewer=-1")["epoch"])
    if epoch <= old_epoch:
        raise AssertionError(f"{label}: epoch {epoch} after a restart of epoch {old_epoch}")
    out = dict(ready_s=ready_s, recovery_ms=gauges["recoveryMs"], epoch_before=old_epoch, epoch_after=epoch,
               journal_bytes=journal)
    log(f"{label}: the controller SIGKILLed and restarted on the same data dir and port: READY in {ready_s:.1f} s, "
        f"the recovery {out['recovery_ms']:.3f} ms, epoch {old_epoch} -> {epoch}, the journal {journal} bytes")
    return out


class QueryLoop:
    """One query sent to the broker back to back on a thread: each answer
    complete and equal to its oracle, partial, or wrong (an answer that
    claims to be complete and is not).  ``stop`` returns the counts."""

    def __init__(self, broker_url: str, name: str, want) -> None:
        self.body = json.dumps({"pql": {**QUERIES, **VALUE_QUERIES}[name]}).encode()
        self.url, self.name, self.want = broker_url, name, want
        self.counts = {"complete": 0, "partial": 0, "wrong": 0}
        self.wrong: List[str] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                d = http_json(self.url + "/query", self.body)
                if d.get("partialResponse"):
                    self.counts["partial"] += 1
                    continue
                check_deployed(self.name, d, self.want)
                self.counts["complete"] += 1
            except Exception as e:
                self.counts["wrong"] += 1
                if len(self.wrong) < 4:
                    self.wrong.append(repr(e)[:400])

    def stop(self) -> dict:
        self._stop.set()
        self._thread.join(timeout=DEPLOY_REQUEST_S)
        return dict(self.counts, first_wrong=self.wrong)


def controller_phase(url: str, broker_url: str, admin: Dict[str, str], tmp: str, wants, record) -> None:
    """19. On phase 17's roles (a controller, server0 with 7 lineitem
    segments, server1 with 1, the broker): (a) the controller SIGKILLed and
    restarted on its data dir and port, q1 looped through the restart (no
    answer wrong), the views refilled, four queries against their oracles
    with K1 / K2 launched; (b) server1 drained over HTTP (the stabilizer
    moves its segment to server0), undrained, and ``RebalanceTable`` moving
    segments back toward 4 / 4, q1 looped through both moves with every
    answer complete and equal to its oracle, the residency pressure of
    ``/debug/capacity`` and the stabilizer's events; (c) every dashboard
    page, ``/debug/stabilizer``'s keys, ``ListTenants`` and ``AddTenant``."""
    rec = record["controller"] = {"card": card_line()}
    table = "lineitem_OFFLINE"
    t_phase = time.perf_counter()

    def launches() -> Dict[str, int]:
        out = {"k1": 0, "k2": 0}
        for a in admin.values():
            got = http_json(a + "/debug/metrics")["kernelLaunches"]
            out = {k: out[k] + got[k] for k in out}
        return out

    def hosted() -> Dict[str, int]:
        return {n: len(http_json(a + "/debug/segments")["segments"].get(table, {})) for n, a in admin.items()}

    def settled() -> bool:
        ideal = http_json(f"{url}/tables/{table}/idealstate")
        return http_json(f"{url}/tables/{table}/externalview") == ideal and len(ideal) == WARM_SEGMENTS

    def wait(what: str, pred) -> float:
        t = time.perf_counter()
        end = time.monotonic() + CTRL_WAIT_S
        while not pred():
            _alive_roles()
            if time.monotonic() > end:
                raise AssertionError(f"controller: {what} not within {CTRL_WAIT_S} s")
            time.sleep(0.2)
        return time.perf_counter() - t

    # (a) the restart, q1 looped through it
    rec["hosted_before"] = hosted()
    loop = QueryLoop(broker_url, "q1", wants["q1"])
    time.sleep(0.5)
    t = time.perf_counter()
    rec["restart"] = restart_controller(url, tmp, "restarted")
    refill_s = wait("the views refilled", settled)
    online_s = wait_online(url, broker_url, table, WARM_SEGMENTS, _alive_roles)
    rec["restart"].update(views_refilled_s=refill_s, online_s=time.perf_counter() - t, broker_online_s=online_s)
    time.sleep(1.0)
    rec["restart"]["loop"] = counts = loop.stop()
    if counts["wrong"] or not counts["complete"]:
        raise AssertionError(f"controller (a): q1 through the restart {counts}")
    per_query = {}
    for name in CTRL_QUERIES:
        b = launches()
        d = http_json(broker_url + "/query", json.dumps({"pql": {**QUERIES, **VALUE_QUERIES}[name]}).encode())
        if d.get("partialResponse"):
            raise AssertionError(f"controller (a) {name}: partial after the views refilled")
        check_deployed(name, d, wants[name])
        per_query[name] = {k: v - b[k] for k, v in launches().items()}
        require_launch(f"controller {name}", per_query[name], CTRL_NEED[name])
    rec["restart"]["hosted_after"] = hosted()
    log(f"controller (a): views refilled {refill_s:.1f} s after READY, every segment ONLINE in the broker's routing "
        f"{rec['restart']['online_s']:.1f} s after the SIGKILL; q1 looped through the restart {counts}; "
        f"{', '.join(CTRL_QUERIES)} equal to their oracles, launches {per_query}; hosted "
        f"{rec['hosted_before']} -> {rec['restart']['hosted_after']}")

    # (b) drain server1, then undrain and rebalance, q1 looped through both
    def staged() -> Dict[str, int]:
        return {n: http_json(a + "/debug/metrics")["stagedBytes"] for n, a in admin.items()}

    drain = rec["drain"] = {"staged_before": staged()}
    loop = QueryLoop(broker_url, "q1", wants["q1"])
    time.sleep(0.5)
    out = http_json(url + "/instances/server1/drain", b"{}")
    drain["segments_moved"] = out["remainingSegments"]
    drain["drained_s"] = wait("server1 drained", lambda: http_json(url + "/instances/server1/drain")["drained"])
    drain["settled_s"] = drain["drained_s"] + wait("the drain settled", lambda: settled() and hosted()["server1"] == 0)
    time.sleep(1.0)
    drain["loop"] = counts = loop.stop()
    if counts["wrong"] or counts["partial"] or not counts["complete"]:
        raise AssertionError(f"controller (b): q1 through the drain {counts}")
    drain["hosted"] = hosted()
    drain["staged_after"] = staged()
    log(f"controller (b): server1 drained in {drain['drained_s']:.1f} s ({drain['segments_moved']} segment(s) "
        f"moved to server0, settled {drain['settled_s']:.1f} s); q1 looped through it {counts}; hosted "
        f"{drain['hosted']}, staged bytes {drain['staged_before']} -> {drain['staged_after']}")
    reb = rec["rebalance"] = {}
    loop = QueryLoop(broker_url, "q1", wants["q1"])
    time.sleep(0.5)
    http_json(url + "/instances/server1/undrain", b"{}")
    t = time.perf_counter()
    cli_s, printed = _admin(["RebalanceTable", "-controller", url, "-table", table], CTRL_WAIT_S)
    plan = json.loads(printed)
    reb.update(cli_s=cli_s, segments_moved=plan["segmentsMoved"], added=plan["added"])
    moved_in = sum(map(len, plan["added"].values()))

    def rebalanced() -> bool:
        if not settled():
            return False
        h = hosted()
        return h["server1"] == moved_in and sum(h.values()) == WARM_SEGMENTS

    reb["settled_s"] = time.perf_counter() - t + wait("the rebalance settled", rebalanced)
    time.sleep(1.0)
    reb["loop"] = counts = loop.stop()
    if counts["wrong"] or counts["partial"] or not counts["complete"]:
        raise AssertionError(f"controller (b): q1 through the rebalance {counts}")
    reb["hosted"] = hosted()
    reb["staged"] = staged()
    capacity = http_json(url + "/debug/capacity")
    reb["pressure"] = {n: (v.get("residency") or {}).get("pressure") for n, v in capacity["servers"].items()}
    stab = http_json(url + "/debug/stabilizer")
    reb["events"] = [{k: e.get(k) for k in ("event", "class", "table", "segment", "server", "src", "dst")}
                     for e in stab["events"]]
    log(f"controller (b): RebalanceTable moved {reb['segments_moved']} segments ({cli_s:.1f} s the CLI), settled "
        f"{reb['settled_s']:.1f} s after it started; q1 looped through it {counts}; hosted {reb['hosted']}, staged "
        f"bytes {reb['staged']}; /debug/capacity's residency pressure {reb['pressure']}; the stabilizer's events "
        f"{[e['event'] for e in reb['events']]}")
    if abs(reb["hosted"]["server0"] - reb["hosted"]["server1"]) > 2:
        raise AssertionError(f"controller (b): hosted after the rebalance {reb['hosted']}")

    # (c) the pages and the CLI
    pages = {}
    for page in CTRL_PAGES:
        with urllib.request.urlopen(url + page, timeout=DEPLOY_REQUEST_S) as r:
            pages[page] = (r.status, r.headers["Content-Type"])
    if any(st != 200 or not ct.startswith("text/html") for st, ct in pages.values()):
        raise AssertionError(f"controller (c): pages {pages}")
    if set(stab) != CTRL_STABILIZER_KEYS:
        raise AssertionError(f"controller (c): /debug/stabilizer's keys {sorted(stab)}")
    _, tenants = _admin(["ListTenants", "-controller", url], 120)
    _, added = _admin(["AddTenant", "-controller", url, "-name", "ctlTenant", "-role", "broker", "-count", "1"], 120)
    if "DefaultTenant" not in json.loads(tenants)["tenants"] or "ctlTenant" not in http_json(url + "/tenants")["tenants"]:
        raise AssertionError(f"controller (c): tenants {tenants} {added}")
    record["paths"]["controller"] = {"launches": per_query,
                                     "totals": {k: sum(v[k] for v in per_query.values()) for k in ("k1", "k2")}}
    rec.update(pages=pages, wall_s=time.perf_counter() - t_phase)
    log(f"controller (c): {len(pages)} pages 200 as HTML, /debug/stabilizer's keys the reference's, ListTenants and "
        f"AddTenant; phase 19 {rec['wall_s']:.1f} s on {rec['card']}")
    log(f"path controller: launches per query {per_query}")


def warmstart_phase(dev, segments, wants, record, roots: List[str], fg, vsc) -> None:
    """17. The lineitem table deployed with ``PINOT_TPU_COMPILE_CACHE_DIR``
    on (a controller, two servers and a broker, each its own process):
    (a) five queries through the broker against their oracles; (b) the
    servers' ``/debug/plans`` and ``/debug/device``, the broker's and the
    controller's ``/debug/workload`` and the controller's
    ``/debug/utilization``: equal digests and counts across the roles, each
    roofline fraction at most 1 against the card's declared peaks, each
    digest's static bytes beside ``data_bound``'s bytes for its launch;
    (c) a ``/debug/profile`` capture around the queries holding K1's and
    K2's kernels by name; (d) the occupancy reading 0 idle and more than 0
    under queries; (e) one server killed and restarted three times (a
    fresh ledger, the same root, prewarming fed by the controller's
    ``/debug/workload``), each digest's first query against the warm p50
    and EXPLAIN's compile state before it."""
    from pinot_tpu_torch.common.tableconfig import TableConfig
    from pinot_tpu_torch.engine.executor import QueryExecutor
    from pinot_tpu_torch.pql import optimize_request, parse_pql
    from pinot_tpu_torch.segment.format import write_segment
    from pinot_tpu_torch.tools.datagen import lineitem_schema

    rec = record["warmstart"] = {"restarts": {}}
    pqls = {n: {**QUERIES, **VALUE_QUERIES}[n] for n in WARM_QUERIES}
    tmp = tempfile.mkdtemp(prefix="pinot-warmstart-")
    t_phase = time.perf_counter()
    table = "lineitem_OFFLINE"
    nrs = WARM_RESTART_SEGMENTS
    restart_env = {"PINOT_TPU_PREWARM_TOP_K": "0"}

    def query(pql: str) -> dict:
        return http_json(broker_url + "/query", json.dumps({"pql": pql}).encode())

    def launches(admins) -> Dict[str, int]:
        out = {"k1": 0, "k2": 0}
        for a in admins:
            got = http_json(a + "/debug/metrics")["kernelLaunches"]
            out = {k: out[k] + got[k] for k in out}
        return out

    def meters(a: str) -> Dict[str, int]:
        snap = http_json(a + "/debug/metrics")["metrics"]["meters"]
        return {k: int(snap.get(k, {}).get("count", 0)) for k in (
            "compile.cold", "compile.warm", "compile.persistentHit", "compile.persistentMiss", "compile.prewarmed",
            "prewarm.compiled", "prewarm.failed")}

    try:
        def write(seg):
            return write_segment(seg, os.path.join(tmp, "files", seg.segment_name))

        # the files are written beside the roles' start
        t = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(max(1, min(len(segments), os.cpu_count() or 1))) as pool:
            written = pool.map(write, segments)
            env = {"PINOT_TPU_COMPILE_CACHE_DIR": roots[0], **restart_env}
            url, admin, broker_url, alive = start_roles(tmp, rec, server_env=env, device=DEPLOY_DEVICE)
            files = list(written)
        rec["write_s"] = time.perf_counter() - t
        log(f"warm start: {len(files)} segment files written beside the roles' start, both done in "
            f"{rec['write_s']:.1f} s")
        http_json(url + "/schemas", json.dumps(lineitem_schema().to_json()).encode())
        http_json(url + "/tables", json.dumps(TableConfig("lineitem").to_json()).encode())
        # the restarted server (server1) hosts the first segments, server0 the rest
        for i, path in enumerate(files):
            with open(path, "rb") as f:
                http_json(f"{url}/segments/{table}?server={'server1' if i < nrs else 'server0'}", f.read(),
                          "application/octet-stream")
        online_s = wait_online(url, broker_url, table, len(files), alive)
        log(f"warm start: {len(files)} segments ONLINE in {online_s:.1f} s after the upload (server1 {nrs}, "
            f"server0 {len(files) - nrs}), the servers' cache root {roots[0]}")

        # (a) the queries through the broker, against their oracles
        per_query = {}
        for name in WARM_QUERIES:
            b = launches(admin.values())
            d = query(pqls[name])
            check_deployed(name, d, wants[name])
            per_query[name] = {k: v - b[k] for k, v in launches(admin.values()).items()}
            require_launch(f"warm start {name}", per_query[name], WARM_NEED[name])
        log(f"warm start (a): every answer equal to its oracle through the broker; launches on the servers "
            f"{per_query}")

        # (b) the planes across the three roles.  A digest's static cost
        # lands on a helper thread after its first launch and joins the
        # plan statistics at a later query: the queries run again (checked)
        # until every server's entries carry it
        for _ in range(10):
            plans = {n: http_json(a + "/debug/plans?top=100")["plans"] for n, a in admin.items()}
            if all((p["roofline"] or {}).get("staticBytesPerExec") for v in plans.values() for p in v):
                break
            time.sleep(0.2)
            for name in WARM_QUERIES:
                check_deployed(name, query(pqls[name]), wants[name])
        bw = http_json(broker_url + "/debug/workload?top=100")
        cw = http_json(url + "/debug/workload?n=100&tables=lineitem")
        util = http_json(url + "/debug/utilization")
        counts = {"broker": {p["digest"]: p["count"] for p in bw["topByCount"]},
                  "controller": {p["digest"]: p["count"] for p in cw["topByCount"]},
                  **{n: {p["digest"]: p["count"] for p in v} for n, v in plans.items()}}
        if len({json.dumps(c, sort_keys=True) for c in counts.values()}) != 1 or len(counts["broker"]) != len(
                WARM_QUERIES):
            raise AssertionError(f"warm start (b): digests and counts differ across the roles {counts}")
        if sorted(util["servers"]) != sorted(admin) or util["unreachable"]:
            raise AssertionError(f"warm start (b): /debug/utilization {util['unreachable']} {sorted(util['servers'])}")
        ex = QueryExecutor(device=dev, precision="x32")
        roofs = {}
        for n, v in plans.items():
            for p in v:
                roof = p["roofline"]
                frac = None if roof is None else roof.get("rooflineFraction")
                if frac is None or not 0 < frac <= 1.0:
                    raise AssertionError(f"warm start (b): {n} {p['summary']}: roofline {roof}")
                # the servers' registries carry no query text: the broker's does
                pql = next(b["exemplarPql"] for b in bw["topByCount"] if b["digest"] == p["digest"])
                name = next(k for k, q in pqls.items() if q == pql)
                # data_bound's bytes of server1's launch, in process over its
                # segments (server0's seven would stage 0.9 GB a query)
                host = segments[:nrs] if n == "server1" else None
                bound_bytes = None
                if host is not None:
                    bound_bytes = launch_bytes(fg, vsc, ex, host, optimize_request(parse_pql(pql)))
                    ex.free_staging()
                roofs[f"{n}/{name}"] = dict(rooflineFraction=frac, bandwidthFraction=roof.get("bandwidthFraction"),
                                            flopsFraction=roof.get("flopsFraction"),
                                            achievedBytesPerSec=roof["achievedBytesPerSec"],
                                            staticBytes=roof.get("staticBytesPerExec"),
                                            staticFlops=roof.get("staticFlopsPerExec"), dataBoundBytes=bound_bytes,
                                            deviceMs=roof["deviceMs"], deviceBytes=roof["deviceBytes"],
                                            deviceDigest=roof.get("deviceDigest"))
                log(f"warm start (b) {n} {name}: rooflineFraction {frac:.6f} (bandwidth "
                    f"{roof.get('bandwidthFraction')}, flops {roof.get('flopsFraction')}; {roof['deviceMs']} ms, "
                    f"{roof['deviceBytes']} bytes), static bytesAccessed {roof.get('staticBytesPerExec')}"
                    + ("" if bound_bytes is None else f" beside data_bound's {bound_bytes} for the same launch "
                                                      f"(in process over its {nrs} segment(s))")
                    + f", static flops {roof.get('staticFlopsPerExec')}")
        del ex
        torch.cuda.empty_cache()
        rec.update(online_s=online_s, counts=counts, roofline=roofs, peaks=util["servers"]["server0"]["device"][
            "platform"], fleet_roofline=util["rooflineFraction"], fleet_totals=util["totals"])
        log(f"warm start (b): digests and counts equal on both servers, the broker and the controller "
            f"{counts['broker']}; declared peaks {rec['peaks']}; fleet rooflineFraction {util['rooflineFraction']}")

        # (c) + (d) a profile capture around the queries on server0, the
        # sampler bracketed to it; the status reader idle, then busy
        a0 = admin["server0"]
        http_json(a0 + "/debug/device")
        http_json(a0 + "/debug/profile/start", json.dumps({"timeoutS": 120}).encode())
        t_idle = time.time()
        time.sleep(0.8)
        idle = http_json(a0 + "/debug/device")["occupancy"]["busyFraction"]
        t_busy = time.time()
        n_burst = 0
        while time.time() - t_busy < WARM_BUSY_S:
            for name in WARM_QUERIES:
                check_deployed(name, query(pqls[name]), wants[name])
                n_burst += 1
        busy = http_json(a0 + "/debug/device")["occupancy"]["busyFraction"]
        t_end = time.time()
        cap = http_json(a0 + "/debug/profile/stop", b"{}")
        dev_snap = http_json(a0 + "/debug/device")
        kern = (cap.get("lastCapture") or {}).get("kernels") or {}
        k1_names, k2_names = capture_kernels(kern)
        samples = (dev_snap.get("sampler") or {}).get("samples") or []
        idle_s = [s["busyFraction"] for s in samples if t_idle + 0.3 < s["ts"] < t_busy]
        busy_s = [s["busyFraction"] for s in samples if t_busy < s["ts"] <= t_end]
        if idle != 0.0 or busy <= 0.0 or any(idle_s) or not any(busy_s):
            raise AssertionError(f"warm start (d): occupancy idle {idle} {idle_s}, busy {busy} {busy_s}")
        # the roofline of each digest again, now over its warm runs too
        warm_roofs = {}
        for n, a in admin.items():
            for p in http_json(a + "/debug/plans?top=100")["plans"]:
                roof = p["roofline"] or {}
                frac = roof.get("rooflineFraction")
                if frac is None or not 0 < frac <= 1.0:
                    raise AssertionError(f"warm start (b): {n} {p['summary']}: roofline after the burst {roof}")
                warm_roofs[f"{n}/{p['summary']}"] = dict(count=p["count"], rooflineFraction=frac,
                                                          deviceMs=roof["deviceMs"], deviceBytes=roof["deviceBytes"],
                                                          achievedBytesPerSec=roof["achievedBytesPerSec"])
        rec["roofline_after_burst"] = warm_roofs
        log(f"warm start (b) after the burst: per server and shape (count, rooflineFraction, achieved TB/s) "
            f"{ {k: (v['count'], v['rooflineFraction'], round(v['achievedBytesPerSec'] / 1e12, 4)) for k, v in warm_roofs.items()} }")
        rec["profile"] = {"kernels": kern, "queries": n_burst, "dir": cap["lastCapture"]["dir"]}
        rec["occupancy"] = {"idle": idle, "busy": busy, "sampler_idle": idle_s, "sampler_busy": busy_s}
        log(f"warm start (c): the capture around {n_burst} queries holds K1 {[(k, kern[k]) for k in k1_names]} "
            f"and K2 {[(k, kern[k]) for k in k2_names]}")
        log(f"warm start (d): busyFraction idle {idle} (sampler {idle_s}), under the queries {busy:.6f} "
            f"(sampler {busy_s})")

        # (e) server1 killed and restarted three times; the launches of
        # every server process of the phase (each counts from 0 at its
        # start) are summed, its incarnations' read before each kill
        role = next(r for r in _ROLES if r.name == "server1")
        killed = {"k1": 0, "k2": 0}
        for label, root_i, prewarm, want_state in WARM_RESTARTS:
            got = launches([admin["server1"]])
            killed = {k: killed[k] + got[k] for k in killed}
            role.proc.kill()
            role.proc.wait(timeout=60)
            _ROLES.remove(role)
            role.log.close()
            env = {"PINOT_TPU_COMPILE_CACHE_DIR": roots[root_i], **({} if prewarm else restart_env)}
            t = time.perf_counter()
            role = _Role(f"server1-{label.replace(' ', '-')}", [
                "StartServer", "-controller", url, "-name", "server1", "-port", "0", "-device", DEPLOY_DEVICE,
                "-precision", "x32"], tmp, env=env)
            words = role.ready(DEPLOY_READY_S)
            ready_s = time.perf_counter() - t
            a1 = admin["server1"] = words[-1]
            tcp = words[2]
            end = time.monotonic() + DEPLOY_ONLINE_S
            while len(http_json(a1 + "/debug/samples?timer=segmentLoad")["samples"]) < nrs:
                for r in list(_ROLES):  # the roles of now: the killed server1 left them
                    r.check_alive()
                if time.monotonic() > end:
                    raise AssertionError(f"warm start {label}: server1 did not load its segments")
                time.sleep(0.1)
            load_s = time.perf_counter() - t - ready_s
            while True:  # the broker routes to the new address
                st = http_json(url + "/clusterstate?ifNewer=-1")
                if ":".join(map(str, st["servers"].get("server1", []))) == tcp:
                    break
                time.sleep(0.1)
            time.sleep(1.0)  # the broker's poll (0.3 s) picks it up
            pw = None
            if prewarm:
                end = time.monotonic() + 120
                while True:
                    pw = http_json(a1 + "/debug/prewarm")
                    if not pw["warming"] and pw["compiled"] >= len(WARM_QUERIES):
                        break
                    if time.monotonic() > end:
                        raise AssertionError(f"warm start {label}: prewarm did not finish {pw}")
                    time.sleep(0.1)
            states, firsts = {}, {}
            for name in WARM_QUERIES:
                node = next(n for n in query("EXPLAIN " + pqls[name])["explain"]["servers"]
                            if n["server"] == "server1")
                states[name] = node["device"]["compile"]["state"]
            if set(states.values()) != {want_state}:
                raise AssertionError(f"warm start {label}: EXPLAIN's compile states {states}, not {want_state}")
            for name in WARM_QUERIES:
                d = query(pqls[name])
                check_deployed(name, d, wants[name])
                first = d["timeUsedMs"]
                warm = []
                for _ in range(WARM_ITERS):
                    d = query(pqls[name])
                    warm.append(d["timeUsedMs"])
                check_deployed(name, d, wants[name])
                node = next(n for n in query("EXPLAIN " + pqls[name])["explain"]["servers"]
                            if n["server"] == "server1")
                comp = node["device"]["compile"]
                firsts[name] = dict(first_ms=first, warm_p50_ms=float(np.median(warm)), firstCallMs=comp.get(
                    "firstCallMs"), launches=comp.get("launches"), launchMsTotal=comp.get("launchMsTotal"),
                    state_after=comp["state"])
            m = meters(a1)
            staging = http_json(a1 + "/debug/samples?timer=phase.staging")["samples"]
            dispatch = http_json(a1 + "/debug/samples?timer=phase.laneDispatch")["samples"]
            if want_state == "cold" and (m["compile.cold"] != len(WARM_QUERIES) or m["compile.persistentMiss"]
                                         != len(WARM_QUERIES)):
                raise AssertionError(f"warm start {label}: meters {m}")
            if want_state != "cold" and m["compile.cold"] != 0:
                raise AssertionError(f"warm start {label}: compile.cold {m['compile.cold']} != 0 ({m})")
            if want_state == "persistent" and m["compile.persistentHit"] != len(WARM_QUERIES):
                raise AssertionError(f"warm start {label}: meters {m}")
            if want_state == "prewarmed" and (m["compile.prewarmed"] != len(WARM_QUERIES) or m["prewarm.failed"]):
                raise AssertionError(f"warm start {label}: meters {m} prewarm {pw}")
            rec["restarts"][label] = dict(ready_s=ready_s, load_s=load_s, states=states, queries=firsts, meters=m,
                                          prewarm=pw, staging_ms=staging, lane_dispatch_ms=dispatch)
            log(f"warm start (e) {label}: READY {ready_s:.1f} s, {nrs} segment(s) loaded {load_s:.1f} s after; "
                f"EXPLAIN before the first query {want_state} for every digest; meters {m}"
                + (f"; prewarm pass {pw['lastPassMs']} ms, {pw['compiled']} shapes" if pw else ""))
            for name, f in firsts.items():
                log(f"warm start (e) {label} {name}: first query {f['first_ms']:.3f} ms (broker timeUsedMs; "
                    f"compile.firstCallMs {f['firstCallMs']}, the lane's launches {f['launchMsTotal']} ms over "
                    f"{f['launches']}) against the warm p50 {f['warm_p50_ms']:.3f} ms of {WARM_ITERS}")
            log(f"warm start (e) {label}: server1's phase.staging ms {[round(x, 3) for x in staging]}, "
                f"phase.laneDispatch ms {[round(x, 3) for x in dispatch]}")
        got = launches(admin.values())
        totals = {k: killed[k] + got[k] for k in killed}
        record["paths"]["warmstart"] = {"launches": per_query, "totals": totals}
        log(f"path warmstart: launches per query {per_query}, total over the phase {totals}")
        planes_deployed_checks(url, broker_url, admin, record)
        controller_phase(url, broker_url, admin, tmp, wants, record)
        for r in list(_ROLES):
            r.check_alive()
    finally:
        codes = _stop_roles()
        rec["exit_codes"] = codes
        log(f"warm start: every role stopped, exit codes {codes}; phase {time.perf_counter() - t_phase:.1f} s")
        shutil.rmtree(tmp, ignore_errors=True)
    bad = {n: c for n, c in codes.items() if c}
    if bad:
        raise AssertionError(f"warm start: a role did not exit cleanly {codes}")


# ---------------------------------------------------------------------------
# 20. Kafka and high-level-consumer ingestion: lineitem rows as JSON
# messages through the Kafka wire protocol and the consumer groups
# ---------------------------------------------------------------------------

KAFKA_PARTITIONS = 2
# (a)'s rowsPerSegment: a partition's rows cross the JSON row path (the
# shim's Fetch, the client's MessageSet decode, json.loads, the mutable
# segment's row indexing) on the host; 2^20, the least this cell keeps,
# holds the phase near 150 s (phase 14's columnar path takes 2^22)
KAFKA_SEGMENT_ROWS = 1 << 18  # (2^20 before phase 21, then 2^19)
KAFKA_PARTITION_ROWS = 3 << 17  # 1.5 x 2^18 a partition: one committed segment, one consuming of 2^17
KAFKA_STAGES = (2, 1)  # the watermarks: half and the whole of the data (the commits land in the second)
KAFKA_PRODUCE_ROWS = 1 << 15  # rows a produce request
HLC_SEGMENT_ROWS = 1 << 15  # (b) and (c): a server's HLC segment (cut from 2^20: the group path's rate; 2^16
# before phase 21)
HLC_PARTITION_ROWS = 3 << 14  # 1.5 x 2^15 a partition
CODEC_ROWS = 1 << 15  # (d): rows a codec (the snappy and lz4 codecs are pure Python; 2^16 before phase 21)
KAFKA_CODECS = ("gzip", "snappy", "lz4")
KAFKA_VISIBLE_S = 600.0  # from a stage's last produce to every row counted
KAFKA_ITERS = 5  # timed broker requests a query at each watermark, after one checked request
KAFKA_HEARTBEAT_TIMEOUT_S = "6"  # the controller's liveness window (the reference's default)
KAFKA_SEEDS = {"llc": 301, "kgroup": 311, "hlc": 321, "codec": 331}


def json_rows(cols: Dict[str, list], lo: int, hi: int) -> List[dict]:
    """Rows [lo, hi) of a segment's value lists (``value_columns`` as
    lists) as the JSON messages a producer sends: one dict a row."""
    names = list(cols)
    return [dict(zip(names, vals)) for vals in zip(*(cols[c][lo:hi] for c in names))]


def kafka_wants(hll_mod, heads) -> dict:
    return {"q1": oracle(heads, "q1"), "count_star": sum(h.num_docs for h in heads),
            "distinct_price": value_oracle(hll_mod, heads, "distinct_price")}


def at_least_once_check(name: str, d: dict, wants: dict) -> None:
    """A reply that may count rows twice (HLC across a rebalance): every
    group of the oracle present with at least its count and sums (every
    lineitem value is non-negative), no group the oracle lacks; exact when
    the counts are."""
    resp = response_from_json(d)
    if resp.exceptions:
        raise AssertionError(f"{name}: {d['exceptions']}")
    if name == "count_star":
        if int(resp.aggregation_results[0].value) < wants["count_star"]:
            raise AssertionError(f"{name}: {resp.aggregation_results[0].value} < {wants['count_star']} produced")
        return
    if name != "q1":
        return  # a distinct count is the same with or without duplicates
    for ar in resp.aggregation_results:
        got = {tuple(g.group): float(g.value) for g in ar.group_by_result}
        if set(got) != set(wants["q1"]):
            raise AssertionError(f"{name} {ar.function}: groups {sorted(got)} != {sorted(wants['q1'])}")
        for key, v in got.items():
            w = wants["q1"][key]["count" if ar.function == "count_star" else ar.function]
            if v < w * (1 - AUDIT_RTOL) - AUDIT_ATOL:
                raise AssertionError(f"{name} {ar.function} {key}: {v} below the oracle's {w}")


def kafka_phase(dev, record, fg, vsc, hll_mod) -> None:
    """20. Kafka and HLC ingestion on a deployed cluster (a controller with
    a 6 s liveness window, two server processes, the broker) and a stream
    broker process (``StartStreamBroker -kafka-port 0``: the topics, the
    native consumer groups and the Kafka v0 wire protocol with its group
    coordinator over the same logs).  The stream is lineitem rows as JSON
    messages, 2 partitions a topic:
    (a) LLC over Kafka (``streamType: kafka``): 1.5 x 2^18 rows a partition,
        rowsPerSegment 2^18, queried at two watermarks (q1, count(*),
        distinct_price against the oracles of the rows produced, each row
        counted exactly once, K1 / K2 launched on the servers); one commit a
        partition through the completion protocol;
    (c) HLC over the Kafka group protocol (``KafkaGroupConsumer``), two
        members, 1.5 x 2^15 rows a partition, segments of 2^15 sealing,
        uploading pinned to their server and rolling: the same queries;
    (d) three more Kafka tables, one a codec: the shim serves gzip, snappy
        and lz4 wrapped message sets, each decoded by the servers and counted;
    (b) HLC over the native stream broker's groups, 1.5 x 2^15 rows a
        partition: server1 SIGKILLed after half of them; the group
        rebalances, the survivor seals at its revoke and re-reads the dead
        member's partition from the committed offsets; the seconds until
        every produced row is counted (at least once), then the queries;
    then K1 and K2 in process at this phase's shapes against their plain
    versions: (a)'s sealed segment and a consuming snapshot indexed from
    partition 0's Kafka messages, and (c)'s sealed HLC segment after its
    roll; and the hybrid quickstart (``HybridQuickstart`` through the CLI,
    and in process with every row counted once across the time boundary)."""
    import dataclasses

    from pinot_tpu_torch.common.tableconfig import StreamConfig, TableConfig
    from pinot_tpu_torch.engine.executor import QueryExecutor
    from pinot_tpu_torch.engine.reduce import reduce_to_response
    from pinot_tpu_torch.pql import optimize_request, parse_pql
    from pinot_tpu_torch.realtime.kafka import KafkaProtocolShim, KafkaStreamProvider
    from pinot_tpu_torch.realtime.llc import make_segment_name, parse_segment_name
    from pinot_tpu_torch.realtime.mutable import MutableSegment
    from pinot_tpu_torch.realtime.netstream import HLConsumer, NetworkStreamProvider, StreamBrokerServer
    from pinot_tpu_torch.segment.format import SEGMENT_FILE_NAME, read_segment
    from pinot_tpu_torch.tools.datagen import lineitem_schema, synthetic_lineitem_segment
    from pinot_tpu_torch.tools.quickstart import HYBRID_SAMPLE_QUERIES, hybrid_events, run_hybrid_quickstart

    rec = record["kafka"] = {"card": card_line()}
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="pinot-kafka-")
    t = time.perf_counter()
    sources = {kind: [synthetic_lineitem_segment(rows, seed=KAFKA_SEEDS[kind] + p, name=f"{kind}{p}")
                      for p in range(KAFKA_PARTITIONS)]
               for kind, rows in (("llc", KAFKA_PARTITION_ROWS), ("kgroup", HLC_PARTITION_ROWS),
                                  ("hlc", HLC_PARTITION_ROWS))}
    sources["codec"] = [synthetic_lineitem_segment(CODEC_ROWS, seed=KAFKA_SEEDS["codec"], name="codec0")]
    cols = {kind: [{c: a.tolist() for c, a in value_columns(s).items()} for s in segs]
            for kind, segs in sources.items()}
    rec["datagen_s"] = time.perf_counter() - t
    log(f"kafka: rows made in {rec['datagen_s']:.1f} s ((a) {KAFKA_PARTITIONS} x "
        f"{KAFKA_PARTITION_ROWS}, (b) and (c) {KAFKA_PARTITIONS} x {HLC_PARTITION_ROWS}, (d) {CODEC_ROWS} a codec)")
    codec_broker = StreamBrokerServer()  # (d)'s topic, in this process: one shim a codec over it
    codec_broker.start()
    shims = {}
    per_query, totals = {}, {"k1": 0, "k2": 0}
    try:
        sb = _Role("streambroker", ["StartStreamBroker", "-port", "0", "-kafka-port", "0"], tmp)
        host, port = sb.ready(DEPLOY_READY_S)[2].rsplit(":", 1)
        port = int(port)
        end = time.monotonic() + DEPLOY_READY_S
        while not any(ln.startswith("READY kafka ") for ln in sb.tail(1 << 20).splitlines()):
            sb.check_alive()
            if time.monotonic() > end:
                raise AssertionError(f"kafka: no Kafka listener within {DEPLOY_READY_S} s:\n{sb.tail()}")
            time.sleep(0.2)
        k_host, k_port = next(ln for ln in sb.tail(1 << 20).splitlines()
                              if ln.startswith("READY kafka ")).split()[2].rsplit(":", 1)
        k_port = int(k_port)
        url, admin, broker_url, alive = start_roles(tmp, rec, heartbeat_timeout=KAFKA_HEARTBEAT_TIMEOUT_S)

        def alive_all():
            alive()
            sb.check_alive()

        def launches():
            out = {"k1": 0, "k2": 0}
            for a in admin.values():
                try:
                    got = http_json(a + "/debug/metrics")["kernelLaunches"]
                except OSError:
                    continue  # a server killed on purpose
                out = {k: out[k] + got[k] for k in out}
            return out

        def samples(timer: str) -> Dict[str, List[float]]:
            out = {}
            for n, a in admin.items():
                try:
                    out[n] = http_json(f"{a}/debug/samples?timer={timer}&last=0")["samples"]
                except OSError:
                    pass
            return out

        def ask(table: str, pql: str) -> dict:
            return http_json(broker_url + "/query", json.dumps({"pql": pql.replace("FROM lineitem",
                                                                                   f"FROM {table}")}).encode())

        def count(table: str) -> int:
            d = ask(table, RT_QUERIES["count_star"])
            return int(response_from_json(d).aggregation_results[0].value) if not d["exceptions"] else -1

        def until_counted(table: str, want: int, label: str, at_least: bool = False) -> Tuple[float, int]:
            """Seconds until the broker counts ``want`` rows of ``table`` (at
            least ``want`` with ``at_least``) with no exception."""
            t0 = time.perf_counter()
            end = time.monotonic() + KAFKA_VISIBLE_S
            while True:
                alive_all()
                got = count(table)
                if got == want or (at_least and got > want):
                    return time.perf_counter() - t0, got
                if time.monotonic() > end:
                    raise AssertionError(f"kafka {label}: {got} rows counted, not {want}, in {KAFKA_VISIBLE_S} s")
                time.sleep(RT_POLL_S)

        def queries(table: str, label: str, wants: dict, check=rt_check, iters: int = KAFKA_ITERS) -> dict:
            """Each query once, checked, with the servers' launches around it,
            then ``iters`` timed requests."""
            out = {}
            for name, pql in RT_QUERIES.items():
                before = launches()
                d = ask(table, pql)
                got = {k: v - before[k] for k, v in launches().items()}
                check(name, d, wants)
                require_launch(f"kafka {label} {name}", got, RT_NEED[name])
                per_query[f"{label}/{name}"] = got
                for k in totals:
                    totals[k] += got[k]
                ms = []
                for _ in range(iters):
                    d = ask(table, pql)
                    if d["exceptions"]:
                        raise AssertionError(f"kafka {label} {name}: {d['exceptions']}")
                    ms.append(d["timeUsedMs"])
                out[name] = {"p50_ms": float(np.percentile(ms, 50)), "p99_ms": float(np.percentile(ms, 99)),
                             "launches": got}
                log(f"kafka {label} {name}: equal to the oracle over the rows produced; broker p50 "
                    f"{out[name]['p50_ms']:.3f} ms, p99 {out[name]['p99_ms']:.3f} ms over {iters}; launches {got}")
            return out

        def create(table: str, topic: str, stream_type: str, consumer: str, seg_rows: int, sh: str, sp: int):
            schema = dataclasses.replace(lineitem_schema(), schema_name=table)
            http_json(url + "/schemas", json.dumps(schema.to_json()).encode())
            config = TableConfig(table, table_type="REALTIME", stream=StreamConfig(
                stream_type=stream_type, topic=topic, rows_per_segment=seg_rows, consumer_type=consumer,
                properties={"host": sh, "port": sp}))
            http_json(url + "/tables", json.dumps(config.to_json()).encode())

        def produce(producer, kind: str, lo: int, hi: int) -> float:
            """Partitions' rows [lo, hi) of ``kind`` on the topic of
            ``producer``, a request of KAFKA_PRODUCE_ROWS at a time, one
            producer a partition in threads; the seconds it took."""
            def one(p):
                out = NetworkStreamProvider(producer.host, producer.port, producer.topic)
                for a in range(lo, hi, KAFKA_PRODUCE_ROWS):
                    out.produce_batch(json_rows(cols[kind][p], a, min(hi, a + KAFKA_PRODUCE_ROWS)), partition=p)

            t0 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(KAFKA_PARTITIONS) as pool:
                list(pool.map(one, range(KAFKA_PARTITIONS)))
            return time.perf_counter() - t0

        # (a) LLC over Kafka
        ra = rec["llc"] = {"stages": {}}
        producer = NetworkStreamProvider(host, port, "li_kafka")
        producer.create_topic(KAFKA_PARTITIONS)
        create("li_kafka", "li_kafka", "kafka", "lowlevel", KAFKA_SEGMENT_ROWS, k_host, k_port)
        commits_before = http_json(url + "/debug/metrics")["controller"]["meters"]["segmentCommits"]["count"]
        done = 0
        for share in KAFKA_STAGES:
            target = KAFKA_PARTITION_ROWS // share
            label = f"(a) 1/{share}" if share > 1 else "(a) all"
            t0 = time.perf_counter()
            produce_s = produce(producer, "llc", done, target)
            visible_s, _ = until_counted("li_kafka", KAFKA_PARTITIONS * target, label)
            st = ra["stages"][label] = {
                "rows_per_partition": target, "produce_s": produce_s,
                "produce_to_visible_ms": visible_s * 1e3,
                "ingest_rows_per_s_per_partition": (target - done) / (time.perf_counter() - t0)}
            log(f"kafka {label}: {target - done} rows a partition produced in {produce_s:.1f} s (JSON over TCP), "
                f"all counted {st['produce_to_visible_ms']:.1f} ms after the last produce returned; ingest "
                f"{st['ingest_rows_per_s_per_partition']:.0f} rows/s a partition through the Kafka row path")
            done = target
            wants = kafka_wants(hll_mod, [head_segment(s, target) for s in sources["llc"]])
            st["queries"] = queries("li_kafka", label, wants)
        ideal = http_json(f"{url}/tables/li_kafka_REALTIME/idealstate")
        want_ideal = {make_segment_name("li_kafka_REALTIME", p, s): v for p in range(KAFKA_PARTITIONS)
                      for s, v in ((0, "ONLINE"), (1, "CONSUMING"))}
        if {s: set(r.values()) for s, r in ideal.items()} != {s: {v} for s, v in want_ideal.items()}:
            raise AssertionError(f"kafka (a): ideal state {ideal}")
        commits = http_json(url + "/debug/metrics")["controller"]["meters"]["segmentCommits"]["count"]
        if commits - commits_before != KAFKA_PARTITIONS:
            raise AssertionError(f"kafka (a): {commits - commits_before} commits, not one a partition")
        ra["commit_ms"] = {k: samples(f"ingest.commit{k}Ms") for k in ("Convert", "File", "Upload", "")}
        log(f"kafka (a): one commit a partition at {KAFKA_SEGMENT_ROWS} rows through the completion protocol; "
            f"by server convert / file / upload / all ms {ra['commit_ms']}")
        alive_all()
        # partition 0's consuming rows, read back through the Kafka protocol
        # in this process while (b)-(d) run: the Kafka-fed consuming snapshot
        # K1 and K2 are held at below
        indexer = concurrent.futures.ThreadPoolExecutor(1)

        def kafka_fed_consuming():
            t0 = time.perf_counter()
            kp = KafkaStreamProvider(k_host, k_port, "li_kafka")
            m = MutableSegment(dataclasses.replace(lineitem_schema(), schema_name="li_kafka"),
                               make_segment_name("li_kafka_REALTIME", 0, 1), "li_kafka_REALTIME")
            off = KAFKA_SEGMENT_ROWS
            while off < KAFKA_PARTITION_ROWS:
                got, off = kp.fetch(0, off, 8192)
                m.index_batch(got)
            kp.client.close()
            return m, time.perf_counter() - t0

        fed = indexer.submit(kafka_fed_consuming)

        # (c) HLC over the Kafka group protocol
        rc = rec["kgroup"] = {}
        producer_c = NetworkStreamProvider(host, port, "li_kgroup")
        producer_c.create_topic(KAFKA_PARTITIONS)
        create("li_kgroup", "li_kgroup", "kafka", "highlevel", HLC_SEGMENT_ROWS, k_host, k_port)
        t0 = time.perf_counter()
        rc["produce_s"] = produce(producer_c, "kgroup", 0, HLC_PARTITION_ROWS)
        visible_s, got = until_counted("li_kgroup", KAFKA_PARTITIONS * HLC_PARTITION_ROWS, "(c)", at_least=True)
        rc.update(produce_to_visible_ms=visible_s * 1e3, counted=got,
                  ingest_rows_per_s_per_partition=HLC_PARTITION_ROWS / (time.perf_counter() - t0))
        log(f"kafka (c) HLC over the Kafka group protocol: {HLC_PARTITION_ROWS} rows a partition produced in "
            f"{rc['produce_s']:.1f} s, {got} counted {rc['produce_to_visible_ms']:.1f} ms after the last produce; "
            f"{rc['ingest_rows_per_s_per_partition']:.0f} rows/s a partition")
        wants_c = kafka_wants(hll_mod, sources["kgroup"])

        def sealed_hlc(physical: str) -> Dict[str, Dict[str, str]]:
            view = http_json(f"{url}/tables/{physical}/externalview")
            return {s: r for s, r in view.items() if set(r.values()) == {"ONLINE"}}

        def rolled() -> Dict[str, Dict[str, str]]:
            """The sealed segments whose idx consumes on at a later
            sequence on the same server (the group decides which member
            holds which partitions, so not every server need have sealed)."""
            view = http_json(f"{url}/tables/li_kgroup_REALTIME/externalview")
            consuming = {(parse_segment_name(s)[1], srv) for s, r in view.items() for srv, v in r.items()
                         if v == "CONSUMING"}
            return {s: r for s, r in sealed_hlc("li_kgroup_REALTIME").items()
                    if any((parse_segment_name(s)[1], srv) in consuming for srv in r)}

        end = time.monotonic() + KAFKA_VISIBLE_S
        while not rolled():
            alive_all()
            if time.monotonic() > end:
                raise AssertionError(f"kafka (c): no sealed HLC segment rolled on: "
                                     f"{http_json(url + '/tables/li_kgroup_REALTIME/externalview')}")
            time.sleep(RT_POLL_S)
        rc["sealed"] = rolled()
        rc["queries"] = queries("li_kgroup", "(c)", wants_c,
                                check=rt_check if got == wants_c["count_star"] else at_least_once_check)
        log(f"kafka (c): sealed HLC segments {rc['sealed']} (each pinned to the server that consumed it, "
            f"consumption rolled on); {got - wants_c['count_star']} rows counted twice")

        # (d) compressed message sets, one table a codec
        rd = rec["codecs"] = {}
        codec_broker.create_topic("li_codec", 1)
        NetworkStreamProvider(*codec_broker.address, "li_codec").produce_batch(
            json_rows(cols["codec"][0], 0, CODEC_ROWS), partition=0)
        for codec in KAFKA_CODECS:
            shims[codec] = KafkaProtocolShim(codec_broker, compression=codec).start()
            table = f"li_{codec}"
            t0 = time.perf_counter()
            create(table, "li_codec", "kafka", "lowlevel", 2 * CODEC_ROWS, *shims[codec].address)
            visible_s, _ = until_counted(table, CODEC_ROWS, f"(d) {codec}")
            rd[codec] = {"rows": CODEC_ROWS, "create_to_counted_s": time.perf_counter() - t0,
                         "rows_per_s": CODEC_ROWS / (time.perf_counter() - t0)}
            log(f"kafka (d) {codec}: {CODEC_ROWS} rows in {codec}-wrapped message sets decoded by a server and "
                f"counted {rd[codec]['create_to_counted_s']:.1f} s after the table's creation "
                f"({rd[codec]['rows_per_s']:.0f} rows/s)")
        d = ask("li_gzip", RT_QUERIES["q1"])
        rt_check("q1", d, {"q1": oracle(sources["codec"], "q1")})

        # (b) HLC over the native consumer groups, a member SIGKILLed
        rb = rec["hlc"] = {}
        producer_b = NetworkStreamProvider(host, port, "li_hlc")
        producer_b.create_topic(KAFKA_PARTITIONS)
        create("li_hlc", "li_hlc", "network", "highlevel", HLC_SEGMENT_ROWS, host, port)
        probe = HLConsumer(host, port, "li_hlc", "li_hlc_REALTIME", "probe")
        end = time.monotonic() + KAFKA_VISIBLE_S
        while True:
            alive_all()
            g = probe.describe_group()
            if len(g["members"]) == 2 and not g["syncPending"]:
                break
            if time.monotonic() > end:
                raise AssertionError(f"kafka (b): the group never formed: {g}")
            time.sleep(RT_POLL_S)
        half = HLC_PARTITION_ROWS // 2
        rb["produce_half_s"] = produce(producer_b, "hlc", 0, half)
        visible_s, _ = until_counted("li_hlc", KAFKA_PARTITIONS * half, "(b) half")
        rb["half_produce_to_visible_ms"] = visible_s * 1e3
        rb["queries_half"] = queries("li_hlc", "(b) half", kafka_wants(
            hll_mod, [head_segment(s, half) for s in sources["hlc"]]), iters=1)
        victim = next(r for r in _ROLES if r.name == "server1")
        victim.proc.kill()
        victim.proc.wait(timeout=60)
        victim.log.close()
        _ROLES.remove(victim)
        killed_at = time.perf_counter()
        rb["produce_rest_s"] = produce(producer_b, "hlc", half, HLC_PARTITION_ROWS)
        visible_s, got = until_counted("li_hlc", KAFKA_PARTITIONS * HLC_PARTITION_ROWS, "(b) after the kill",
                                       at_least=True)
        rb.update(kill_to_counted_s=time.perf_counter() - killed_at, counted=got,
                  produced=KAFKA_PARTITIONS * HLC_PARTITION_ROWS, committed=probe.committed_offsets(),
                  group=probe.describe_group())
        wants_b = kafka_wants(hll_mod, sources["hlc"])
        rb["queries"] = queries("li_hlc", "(b) after the kill", wants_b,
                                check=rt_check if got == wants_b["count_star"] else at_least_once_check)
        log(f"kafka (b): server1 SIGKILLed after {half} rows a partition; every one of the "
            f"{rb['produced']} produced rows counted ({got} counted, {got - rb['produced']} twice) "
            f"{rb['kill_to_counted_s']:.1f} s after the kill (the group's session 10 s, the controller's "
            f"liveness {KAFKA_HEARTBEAT_TIMEOUT_S} s); the group now {rb['group']}, committed offsets "
            f"{rb['committed']}; sealed {sorted(sealed_hlc('li_hlc_REALTIME'))}")
        record["paths"]["kafka"] = {"launches": per_query, "totals": totals}

        # K1 and K2 at this phase's shapes, in process
        def fetch_sealed(physical: str, seg: str):
            d_ = os.path.join(tmp, "sealed", seg)
            os.makedirs(d_)
            with urllib.request.urlopen(f"{url}/segments/{physical}/{seg}/file", timeout=DEPLOY_REQUEST_S) as r:
                with open(os.path.join(d_, SEGMENT_FILE_NAME), "wb") as f:
                    shutil.copyfileobj(r, f)
            return read_segment(d_)

        mutable, fed_s = fed.result()
        indexer.shutdown(wait=True)
        rec["kafka_fed_rows_per_s"] = mutable.num_docs / fed_s
        t = time.perf_counter()
        snap = mutable.snapshot()
        rec["kafka_fed_snapshot_ms"] = (time.perf_counter() - t) * 1e3
        sealed_a = fetch_sealed("li_kafka_REALTIME", make_segment_name("li_kafka_REALTIME", 0, 0))
        hlc_seg = sorted(rc["sealed"], key=lambda s: parse_segment_name(s)[2])[0]
        sealed_c = fetch_sealed("li_kgroup_REALTIME", hlc_seg)
        ex = QueryExecutor(device=dev, precision="x32")
        shapes = rec["shapes"] = {}
        for label, segs, heads in (("(a) sealed + Kafka-fed consuming snapshot", [sealed_a, snap],
                                    [head_segment(sources["llc"][0], KAFKA_PARTITION_ROWS)]),
                                   ("(c) sealed HLC segment after its roll", [sealed_c], None)):
            tbl = segs[0].metadata.table_name.replace("_REALTIME", "")
            q1 = RT_QUERIES["q1"].replace("FROM lineitem", f"FROM {tbl}")
            dp = RT_QUERIES["distinct_price"].replace("FROM lineitem", f"FROM {tbl}")
            k1 = k1_captured(fg, f"kafka {label}", lambda: ex.execute(segs, optimize_request(parse_pql(q1))))
            req = optimize_request(parse_pql(dp))
            k2 = k2_captured(vsc, f"kafka {label} distinct_price", lambda: ex.execute(segs, req))
            if heads is not None:
                check_response(reduce_to_response(optimize_request(parse_pql(q1)),
                                                  [ex.execute(segs, optimize_request(parse_pql(q1)))]),
                               oracle(heads, "q1"))
                check_value_response(reduce_to_response(req, [ex.execute(segs, req)]),
                                     value_oracle(hll_mod, heads, "distinct_price"))
            shapes[label] = {"k1": k1, "k2": k2}
            ex.free_staging()
        log(f"kafka: partition 0's consuming rows read back through Fetch in this process at "
            f"{rec['kafka_fed_rows_per_s']:.0f} rows/s, its snapshot {rec['kafka_fed_snapshot_ms']:.1f} ms")
        rec["k1"] = shapes["(a) sealed + Kafka-fed consuming snapshot"]["k1"]
        rec["k2"] = shapes["(a) sealed + Kafka-fed consuming snapshot"]["k2"]
        rec["hlc_k1"] = shapes["(c) sealed HLC segment after its roll"]["k1"]
        rec["hlc_k2"] = shapes["(c) sealed HLC segment after its roll"]["k2"]
        del ex, segs, snap, mutable, sealed_a, sealed_c
        torch.cuda.empty_cache()
    finally:
        codes = _stop_roles()
        for shim in shims.values():
            shim.stop()
        codec_broker.stop()
        rec["exit_codes"] = codes
        shutil.rmtree(tmp, ignore_errors=True)
    if any(codes.values()):
        raise AssertionError(f"kafka: a role did not exit cleanly {codes}")

    # the hybrid quickstart: the CLI on the card, then in process with its
    # answers checked against the events it made
    rh = rec["hybrid"] = {}
    t = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "pinot_tpu_torch.tools.admin", "HybridQuickstart", "-no-http",
                          "-device", DEPLOY_DEVICE], cwd=REPO_DIR, capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=REPO_DIR + os.pathsep + os.environ.get("PYTHONPATH", "")))
    rh["cli_s"] = time.perf_counter() - t
    if out.returncode != 0 or "DONE hybrid quickstart" not in out.stdout:
        raise AssertionError(f"kafka hybrid CLI: exit {out.returncode}\n{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
    base_ms = 1_600_000_000_000
    offline_rows, realtime_rows = hybrid_events(1500, 800, base_ms)
    boundary = max(e["mtime"] for e in offline_rows)
    events = offline_rows + [e for e in realtime_rows if e["mtime"] > boundary]  # each row once
    fg.launches = vsc.launches = 0
    cluster = run_hybrid_quickstart(verbose=False, device=dev, base_ms=base_ms)
    try:
        answers = [cluster.query(pql) for pql in HYBRID_SAMPLE_QUERIES]
    finally:
        cluster.stop()
    rh["launches"] = {"k1": fg.launches, "k2": vsc.launches}
    cities: Dict[str, int] = {}
    for e in events:
        cities[e["group_city"]] = cities.get(e["group_city"], 0) + e["rsvp_count"]
    want = [len(events), max(e["mtime"] for e in events)]
    got = [int(float(answers[0].aggregation_results[0].value)), int(float(answers[1].aggregation_results[0].value))]
    by_city = {g.group[0]: int(float(g.value)) for g in answers[2].aggregation_results[0].group_by_result}
    if got != want or by_city != cities or any(a.exceptions for a in answers):
        raise AssertionError(f"kafka hybrid: {got} / {by_city} against {want} / {cities}")
    require_launch("kafka hybrid", rh["launches"], "k1")
    record["paths"]["hybrid"] = {"launches": {"all": rh["launches"]}, "totals": dict(rh["launches"])}
    log(f"kafka hybrid: the CLI answered its three queries in {rh['cli_s']:.1f} s; in process count(*) {got[0]} "
        f"(each of the 100 overlapping rows once across the time boundary), max(mtime) and the city sums equal to "
        f"the events; launches {rh['launches']}")
    summary = {label: {k: st[k] for k in ("ingest_rows_per_s_per_partition", "produce_to_visible_ms")}
               for label, st in rec["llc"]["stages"].items()}
    summary.update(
        kgroup={k: rec["kgroup"][k] for k in ("ingest_rows_per_s_per_partition", "produce_to_visible_ms")},
        codecs_rows_per_s={c: v["rows_per_s"] for c, v in rec["codecs"].items()},
        hlc_kill_to_counted_s=rec["hlc"]["kill_to_counted_s"], commit_ms=rec["llc"]["commit_ms"],
        k1_ms_bound_ms={lab: [s["k1"]["ms"], s["k1"]["bound_ms"]] for lab, s in rec["shapes"].items()},
        k2_ms_bound_ms={lab: [s["k2"]["ms"], s["k2"]["bound_ms"]] for lab, s in rec["shapes"].items()})
    rec["wall_s"] = time.perf_counter() - t_phase
    log(f"kafka summary on {rec['card']}: {json.dumps(summary)}")
    log(f"kafka: every role stopped (server1 SIGKILLed in (b)), exit codes {codes}; phase {rec['wall_s']:.1f} s")


NF_SERVERS = 3
NF_SEGMENTS = 6
NF_ROWS = 1 << 22  # rows a segment (phase 14's): 6 x 2^22 = 25,165,824 rows
NF_REPLICATION = 2
NF_CLIENTS = 4  # closed-loop clients, each sending q1 and distinct_price in turn
NF_QUERIES = {"q1": Q1, "distinct_price": VALUE_QUERIES["distinct_price"]}
NF_NEED = {"q1": "k1", "distinct_price": "k2"}
NF_SEED = 2100  # offline segment i draws from seed 2100 + i
NF_FAULT_SEED = 21  # the NetworkFaultInjector's seed
NF_RT_PARTITIONS = 2
NF_RT_ROWS = 1 << 20  # (c): rows a partition, and rowsPerSegment: one commit a partition, during the cut
NF_RT_SEED = 2110  # (c)'s partition p draws from seed 2110 + p
NF_RT_BATCH = 1 << 16  # rows a fetch of the file stream (PINOT_TPU_INGEST_BATCH_ROWS; phase 14's block)
NF_WAIT_S = 300.0  # a step's deadline (cluster.wait)
NF_WINDOW_S = 0.5  # closed-loop serving before a fault and after a heal
NF_POLL_S = 0.5  # a count(*) at most this often while a step waits on one (each stages a new snapshot)


def nf_check(name: str, resp, want) -> None:
    """A complete phase-21 answer against the answer from before the
    faults: q1's counts exactly and sums within the audit band,
    distinct_price exactly."""
    if resp.exceptions:
        raise AssertionError(f"{name}: exceptions on a complete answer {[e.to_json() for e in resp.exceptions]}")
    if name == "q1":
        check_response(resp, want)
    else:
        check_value_response(resp, want)


class NetLoad:
    """``clients`` threads sending NF_QUERIES in turn through the broker
    back to back.  A complete answer must equal the answer from before the
    faults (``nf_check``), an incomplete one must say so
    (``partialResponse``); anything else is a failure.  Answers are counted
    by the step running when they came back (``label``)."""

    def __init__(self, broker, wants: dict, clients: int = NF_CLIENTS) -> None:
        self.broker, self.wants = broker, wants
        self.label = "warm"
        self.counts: Dict[str, Dict[str, int]] = {}
        self.ms: Dict[str, List[float]] = {}  # label -> client ms of its complete answers
        self.failures: List[str] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._loop, args=(i,), name=f"nf-load-{i}", daemon=True)
                         for i in range(clients)]
        for t in self._threads:
            t.start()

    def _loop(self, i: int) -> None:
        names = list(NF_QUERIES)
        while not self._stop.is_set():
            name = names[i % len(names)]
            i += 1
            label = self.label
            t = time.perf_counter()
            try:
                resp = self.broker.handle_pql(NF_QUERIES[name])
                if resp.partial_response:
                    kind = "partial"
                else:
                    nf_check(name, resp, self.wants[name])
                    kind = "ok"
                    with self._lock:
                        self.ms.setdefault(label, []).append((time.perf_counter() - t) * 1e3)
            except Exception as e:  # a raised handler or a wrong answer
                kind = "failed"
                with self._lock:
                    if len(self.failures) < 8:
                        self.failures.append(f"{label} {name}: {type(e).__name__}: {e}"[:400])
            with self._lock:
                c = self.counts.setdefault(label, {"ok": 0, "partial": 0, "failed": 0})
                c[kind] += 1

    def stop(self) -> Dict[str, Dict[str, int]]:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=120)
        return self.counts

    def latency(self) -> Dict[str, Dict[str, float]]:
        """Client p50 / p99 ms of the complete answers, by step."""
        with self._lock:
            return {k: {"p50": float(np.percentile(v, 50)), "p99": float(np.percentile(v, 99)), "n": len(v)}
                    for k, v in self.ms.items() if v}


def k2_captured(vsc, label: str, run) -> dict:
    """K2 at the shape a path hands it: its last launch in ``run()``,
    captured, bit-equal to its plain version in every tier that takes it,
    timed (CUDA events) and beside its bound on this data."""
    captured: dict = {}
    restore = _capture(vsc, "value_state", captured, "k2")
    try:
        run()
    finally:
        vsc.value_state = restore
    (mode, *rest), kw = captured["k2"]
    args = {**dict(zip(("num_docs", "values"), rest)), **kw}
    tiers = compare_k2_value(vsc, mode, args)
    k_ms, _ = cuda_ms(lambda: vsc.value_state(mode, **args), ITERS)
    p_ms, _ = cuda_ms(lambda: vsc.value_state_reference(mode, **args), 1, warmup=0)
    matched = int(vsc.value_state(mode, **args)[0])
    bound, bound_by, nbytes, ops = k2_bound(vsc, mode, args, matched)
    idx, K, _ = vsc.combine_index(mode, **args)
    lib_ms, _ = cuda_ms(lambda: torch.bincount(idx.reshape(-1), minlength=K + 1)[:K], ITERS)
    del idx
    log(f"k2 {label} ({mode}, values {list(args['values'].shape)}, K={K}, {matched} rows matched): {k_ms:.4f} ms "
        f"(bound {bound:.4f} ms by {bound_by}: {nbytes} bytes, {ops} operations; {bound / k_ms:.3f} of the bound), "
        f"plain {p_ms:.4f} ms, torch.bincount over the combined index {lib_ms:.4f} ms, bit-equal in tiers {tiers}")
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=bound_by, bytes=nbytes, operations=ops,
                library_ms=lib_ms, tiers=tiers, mode=mode, K=K, shape=list(args["values"].shape), matched=matched,
                max_abs_err=0.0)


def nf_stream_sources(rows: int) -> list:
    """(c)'s rows: one lineitem segment of ``rows`` a stream partition."""
    from pinot_tpu_torch.tools.datagen import synthetic_lineitem_segment

    return [synthetic_lineitem_segment(rows, seed=NF_RT_SEED + p, name=f"asym{p}") for p in range(NF_RT_PARTITIONS)]


def nf_write_streams(out_dir: str, rows: int) -> None:
    """(c)'s JSON lines, each partition's two halves a file
    (``p<partition>.<half>.jsonl``).  Run in a process of its own
    (``python -c``), so the JSON encoding holds none of the cluster's
    interpreter."""
    half = rows // 2
    for p, seg in enumerate(nf_stream_sources(rows)):
        cols = {c: a.tolist() for c, a in value_columns(seg).items()}
        for i, (lo, hi) in enumerate(((0, half), (half, rows))):
            with open(os.path.join(out_dir, f"p{p}.{i}.jsonl"), "w") as f:
                f.write("".join(json.dumps(r) + "\n" for r in json_rows(cols, lo, hi)))


def throttled(fn, period_s: float = NF_POLL_S):
    """``fn`` called at most once a ``period_s``; the last answer between."""
    last = {"t": -1e18, "v": False}

    def call():
        now = time.monotonic()
        if now - last["t"] >= period_s:
            last["t"], last["v"] = now, fn()
        return last["v"]

    return call


def netfaults_phase(dev, record, fg, vsc, hll_mod) -> None:
    """21. The link fault plane on a networked cluster in this process
    (``NetworkedCluster(device="cuda")``: a controller, three servers and a
    broker over HTTP and TCP, the lease 2.5 s, heartbeats every 0.2 s, the
    liveness window 1.2 s, polls every 0.1 s), every link through one
    seeded ``NetworkFaultInjector``.  The OFFLINE lineitem table: 6
    segments of 2^22 rows at replication 2.  q1 (K1) and distinct_price
    (K2) run as closed-loop load from 4 clients through every scenario;
    every complete answer equals the answer from before the faults (counts
    exactly, sums within the audit band), every incomplete one is flagged
    ``partialResponse``, and anything else fails the phase:
    (a) one server cut from the controller both ways past its lease: the
        seconds from the cut to the first replica that moves against the
        lease, ``leaseDeferrals``, the seconds to rejoin after the heal;
    (b) the controller cut from every role: the broker serves from its
        snapshot, nothing moves, the ideal state after the heal is
        byte-identical to the one before; the queries served meanwhile;
    (c) a REALTIME lineitem table fed by a file stream (2 partitions of
        2^20 rows, rowsPerSegment 2^20, replication 2): the replies to one
        replica lost while the second half of the rows arrives; exactly one
        committed segment a partition, by the healthy replica, the same
        bytes on both replicas after the heal, count(*) equal to the rows
        produced and q1 / distinct_price to their oracles;
    (d) disaster recovery: a backup while serving, the controller and its
        property store lost, the archive restored, a new controller on the
        same port and the servers reloaded through it; the backup's and
        the restore's seconds and the archive's bytes, every answer after
        equal to the one before, and a write of the old controller raising
        ``StaleEpochError``;
    then K1 and K2 at this phase's shapes against their plain versions."""
    import dataclasses

    from pinot_tpu_torch.common.fencing import StaleEpochError
    from pinot_tpu_torch.common.tableconfig import StreamConfig, TableConfig
    from pinot_tpu_torch.controller.controller import Controller, ControllerHttpServer
    from pinot_tpu_torch.realtime.llc import make_segment_name
    from pinot_tpu_torch.realtime.stream import FileBasedStreamProvider
    from pinot_tpu_torch.tools.backup import create_backup, restore_backup
    from pinot_tpu_torch.tools.cluster_harness import NetworkedCluster
    from pinot_tpu_torch.tools.datagen import lineitem_schema, synthetic_lineitem_segment

    rec = record["netfaults"] = {"card": card_line()}
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="pinot-netfaults-")
    t = time.perf_counter()
    # (c)'s JSON lines in a process of its own, beside everything below
    stream_dir = os.path.join(tmp, "stream")
    os.makedirs(stream_dir)
    writer = subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke.nf_write_streams({stream_dir!r}, {NF_RT_ROWS})"],
        cwd=REPO_DIR, env=dict(os.environ, PYTHONPATH=REPO_DIR + os.pathsep + os.environ.get("PYTHONPATH", "")))
    with concurrent.futures.ThreadPoolExecutor(NF_SEGMENTS) as pool:
        segs = list(pool.map(lambda i: synthetic_lineitem_segment(NF_ROWS, seed=NF_SEED + i, name=f"nf{i}"),
                             range(NF_SEGMENTS)))
    rt_sources = nf_stream_sources(NF_RT_ROWS)
    rec["datagen_s"] = time.perf_counter() - t
    log(f"netfaults: {NF_SEGMENTS} x {NF_ROWS} lineitem rows and (c)'s {NF_RT_PARTITIONS} x {NF_RT_ROWS} made in "
        f"{rec['datagen_s']:.1f} s")
    # the oracles in threads beside the cluster's start
    helpers = concurrent.futures.ThreadPoolExecutor(3)
    pending = {"q1": helpers.submit(oracle, segs, "q1"),
               "distinct_price": helpers.submit(value_oracle, hll_mod, segs, "distinct_price")}
    rt_wants = helpers.submit(lambda: {"q1": oracle(rt_sources, "q1"),
                                       "distinct_price": value_oracle(hll_mod, rt_sources, "distinct_price")})
    helpers.shutdown(wait=False)
    cluster = load = None
    launches: Dict[str, Dict[str, int]] = {}
    steps = rec["steps_s"] = {}
    old_batch = os.environ.get("PINOT_TPU_INGEST_BATCH_ROWS")
    os.environ["PINOT_TPU_INGEST_BATCH_ROWS"] = str(NF_RT_BATCH)  # read when the servers are made
    try:
        t = time.perf_counter()
        cluster = NetworkedCluster(num_servers=NF_SERVERS, data_dir=os.path.join(tmp, "cluster"),
                                   seed=NF_FAULT_SEED, device=str(dev))
        ctrl = cluster.controller
        ctrl.stabilizer.grace_s = 0.0  # the lease is the guard under test
        # no skew rebalance: (a) leaves its rejoined victim without replicas,
        # and (b) and (c) hold that nothing moves
        ctrl.stabilizer.rebalance_enabled = False
        res, st = ctrl.resources, ctrl.stabilizer
        ctrl.add_schema(lineitem_schema())
        physical = ctrl.add_table(TableConfig("lineitem", table_type="OFFLINE", replication=NF_REPLICATION))
        for seg in segs:
            ctrl.upload_segment(physical, seg)
        total = NF_SEGMENTS * NF_ROWS

        def converged(table: str) -> bool:
            ideal, view = res.get_ideal_state(table), res.get_external_view(table)
            return bool(ideal) and view == ideal and all(s == "ONLINE" for r in view.values() for s in r.values())

        def count(table: str) -> int:
            r = cluster.query(f"SELECT count(*) FROM {table}")
            return -1 if r.exceptions or r.partial_response else r.num_docs_scanned

        cluster.wait(lambda: converged(physical) and len(res.get_ideal_state(physical)) == NF_SEGMENTS,
                     timeout_s=NF_WAIT_S, what="every replica ONLINE")
        cluster.wait(throttled(lambda: count("lineitem") == total), timeout_s=NF_WAIT_S,
                     what="the broker serving every row")
        steps["start_upload_load"] = time.perf_counter() - t
        per_server = {s.name: sum(1 for r in res.get_ideal_state(physical).values() if s.name in r)
                      for s in cluster.server_starters}
        log(f"netfaults: {NF_SERVERS} servers, the controller and the broker up, {NF_SEGMENTS} segments uploaded "
            f"and every replica ONLINE ({per_server} a server) in {steps['start_upload_load']:.1f} s")

        # the path: every launch count 0 just before, read just after
        fg.launches = vsc.launches = 0
        wants = {}
        t = time.perf_counter()
        for name in NF_QUERIES:
            before = (fg.launches, vsc.launches)
            # a few requests first: the broker spreads them over the replicas,
            # and each server stages its segments once
            for _ in range(NF_SERVERS * NF_REPLICATION):
                resp = cluster.query(NF_QUERIES[name])
                if resp.partial_response or resp.exceptions:
                    raise AssertionError(f"netfaults baseline {name}: {resp.to_json()}")
            got = {"k1": fg.launches - before[0], "k2": vsc.launches - before[1]}
            require_launch(f"netfaults baseline {name}", got, NF_NEED[name])
            if name == "q1":
                worst = check_response(resp, pending[name].result())
                wants[name] = response_as_want(resp)
                log(f"netfaults baseline q1: equal to the oracle (max rel sum err {worst:.3g}); launches {got}")
            else:
                check_value_response(resp, pending[name].result())
                wants[name] = pending[name].result()
                log(f"netfaults baseline distinct_price: equal to the oracle, exact; launches {got}")
            launches[f"baseline/{name}"] = got
        steps["baseline"] = time.perf_counter() - t

        load = NetLoad(cluster.broker, wants)
        time.sleep(NF_WINDOW_S)

        def mark(label: str) -> Tuple[int, int]:
            load.label = label
            return fg.launches, vsc.launches

        def launched(label: str, since: Tuple[int, int]) -> None:
            launches[label] = {"k1": fg.launches - since[0], "k2": vsc.launches - since[1]}

        # (a) partition-server
        ra = rec["partition_server"] = {}
        since = mark("partition-server")
        t = time.perf_counter()
        victim = max(per_server, key=lambda n: (per_server[n], n))
        vsrv = cluster.server(victim).server
        ideal_pre = res.get_ideal_state(physical)
        deferrals0 = st.metrics.meter("stabilizer.leaseDeferrals").count
        added0 = st.metrics.meter("stabilizer.replicasAdded").count
        t_cut = time.monotonic()
        cluster.faults.partition(victim, "controller")
        cluster.wait(lambda: not res.instances[victim].alive, timeout_s=NF_WAIT_S,
                     what="the controller declaring the victim dead")
        ra["cut_to_dead_s"] = time.monotonic() - t_cut
        st.run_once()  # dead at the gateway, its lease still live: nothing may move
        ra["held_through_lease"] = res.get_ideal_state(physical) == ideal_pre
        ra["lease_deferrals"] = st.metrics.meter("stabilizer.leaseDeferrals").count - deferrals0
        lease_until = res.instances[victim].lease_until
        cluster.wait(lambda: not vsrv.lease.held(), timeout_s=NF_WAIT_S, what="the victim's lease expiring")
        ra["victim_fenced_s"] = time.monotonic() - t_cut
        moved = {}

        def step_until_moved() -> bool:
            st.run_once()
            if "t" not in moved and res.get_ideal_state(physical) != ideal_pre:
                moved["t"] = time.monotonic()
            return not any(victim in r for r in res.get_ideal_state(physical).values())

        cluster.wait(step_until_moved, timeout_s=NF_WAIT_S, what="the victim's replicas moved after its lease")
        ra["cut_to_first_move_s"] = moved["t"] - t_cut
        ra["moved_after_lease"] = lease_until is not None and moved["t"] >= lease_until
        ra["lease_s"] = cluster.lease_s
        cluster.wait(lambda: converged(physical)
                     and all(len(r) == NF_REPLICATION for r in res.get_ideal_state(physical).values()),
                     timeout_s=NF_WAIT_S, what="re-replication on the other servers")
        ra["cut_to_rereplicated_s"] = time.monotonic() - t_cut
        ra["replicas_added"] = st.metrics.meter("stabilizer.replicasAdded").count - added0
        time.sleep(NF_WINDOW_S)
        t_heal = time.monotonic()
        cluster.faults.heal()
        cluster.wait(lambda: res.instances[victim].alive and vsrv.lease.held(), timeout_s=NF_WAIT_S,
                     what="the victim re-admitted with its lease renewed")
        ra["heal_to_rejoin_s"] = time.monotonic() - t_heal
        time.sleep(NF_WINDOW_S)
        launched("partition-server", since)
        ra.update(load.counts.get("partition-server", {}))
        steps["partition_server"] = time.perf_counter() - t
        if not (ra["held_through_lease"] and ra["moved_after_lease"] and ra["lease_deferrals"] > 0
                and ra["failed"] == 0):
            raise AssertionError(f"netfaults (a): {ra} {load.failures} {cluster.broker.admission.snapshot()}")
        log(f"netfaults (a) partition-server {victim}: {ra['failed']} failed of {ra['ok'] + ra['partial']} "
            f"answered ({ra['partial']} flagged partial); dead at the controller {ra['cut_to_dead_s']:.2f} s after "
            f"the cut, nothing moved inside the lease (leaseDeferrals {ra['lease_deferrals']}), the first replica "
            f"moved {ra['cut_to_first_move_s']:.2f} s after the cut against the {ra['lease_s']} s lease, "
            f"{ra['replicas_added']} replicas re-homed in {ra['cut_to_rereplicated_s']:.2f} s; rejoined "
            f"{ra['heal_to_rejoin_s']:.2f} s after the heal; launches {launches['partition-server']}")

        # (b) partition-controller
        rb = rec["partition_controller"] = {}
        since = mark("partition-controller/outage")
        t = time.perf_counter()
        ideal_before = json.dumps(res.get_ideal_state(physical), sort_keys=True)
        cluster.faults.partition("brk0", "controller")  # the broker first: it keeps the healthy snapshot
        time.sleep(0.15)
        for s in cluster.server_starters:
            cluster.faults.partition(s.name, "controller")
        t_cut = time.monotonic()
        cluster.wait(lambda: all(not res.instances[s.name].alive for s in cluster.server_starters),
                     timeout_s=NF_WAIT_S, what="the controller declaring every server dead")
        cluster.wait(lambda: cluster.broker.metrics.gauge("controller.unreachable").value == 1, timeout_s=NF_WAIT_S,
                     what="the broker's unreachable gauge")
        cluster.wait(lambda: all(not s.server.lease.held() for s in cluster.server_starters), timeout_s=NF_WAIT_S,
                     what="every server's lease expiring")
        for _ in range(3):
            st.run_once()
        rb["ideal_unchanged_during"] = json.dumps(res.get_ideal_state(physical), sort_keys=True) == ideal_before
        time.sleep(NF_WINDOW_S)
        rb["outage_s"] = time.monotonic() - t_cut
        mark("partition-controller/heal")
        cluster.faults.heal()
        t_heal = time.monotonic()
        serving_all = throttled(lambda: count("lineitem") == total)
        cluster.wait(lambda: all(res.instances[s.name].alive and s.server.lease.held()
                                 for s in cluster.server_starters)
                     and cluster.broker.metrics.gauge("controller.unreachable").value == 0
                     and converged(physical) and serving_all(),
                     timeout_s=NF_WAIT_S, what="every role re-admitted and the broker serving every row")
        rb["heal_to_converged_s"] = time.monotonic() - t_heal
        st.run_once()
        rb["ideal_byte_identical_after"] = json.dumps(res.get_ideal_state(physical), sort_keys=True) == ideal_before
        time.sleep(NF_WINDOW_S)
        launched("partition-controller", since)
        out_c, heal_c = (load.counts.get(k, {"ok": 0, "partial": 0, "failed": 0})
                         for k in ("partition-controller/outage", "partition-controller/heal"))
        rb.update(served_during_outage=out_c["ok"] + out_c["partial"], outage=out_c, heal=heal_c)
        steps["partition_controller"] = time.perf_counter() - t
        if not (rb["ideal_unchanged_during"] and rb["ideal_byte_identical_after"] and out_c["failed"] == 0
                and heal_c["failed"] == 0 and out_c["ok"] > 0):
            raise AssertionError(f"netfaults (b): {rb} {load.failures} {cluster.broker.admission.snapshot()}")
        log(f"netfaults (b) partition-controller: {rb['served_during_outage']} queries served from the broker's "
            f"snapshot during the {rb['outage_s']:.2f} s outage ({out_c['partial']} flagged partial, "
            f"{out_c['failed']} failed), no replica moved, the ideal state byte-identical after the heal; converged "
            f"{rb['heal_to_converged_s']:.2f} s after it ({heal_c}); launches {launches['partition-controller']}")

        # (c) asymmetric partition on a REALTIME table fed by a file stream
        rc = rec["asymmetric"] = {}
        since = mark("asymmetric")
        t = time.perf_counter()
        rt_table = "li_asym"
        paths = [os.path.join(tmp, f"{rt_table}_p{p}.jsonl") for p in range(NF_RT_PARTITIONS)]
        if writer.wait(timeout=NF_WAIT_S) != 0:
            raise AssertionError(f"netfaults (c): the stream writer exited {writer.returncode}")
        rc["text_ready_s"] = time.perf_counter() - t
        for p, path in enumerate(paths):
            shutil.copyfile(os.path.join(stream_dir, f"p{p}.0.jsonl"), path)
        ctrl.add_schema(dataclasses.replace(lineitem_schema(), schema_name=rt_table))
        rt_physical = ctrl.add_realtime_table(
            TableConfig(rt_table, table_type="REALTIME", replication=NF_REPLICATION,
                        stream=StreamConfig(stream_type="file", rows_per_segment=NF_RT_ROWS,
                                            properties={"paths": paths})),
            FileBasedStreamProvider(paths))
        seg0 = [make_segment_name(rt_physical, p, 0) for p in range(NF_RT_PARTITIONS)]
        half = NF_RT_ROWS // 2

        def consumed(rows: int) -> bool:
            """Every replica's consumer of ``seg0`` at ``rows`` (no query:
            a count(*) stages a new snapshot of every consuming segment)."""
            offsets = [c.offset for s in cluster.server_starters for seg, c in list(s._consumers.items())
                       if seg in seg0]
            return len(offsets) == NF_RT_PARTITIONS * NF_REPLICATION and min(offsets) >= rows

        cluster.wait(lambda: consumed(half), timeout_s=NF_WAIT_S, what="(c)'s first half consumed")
        cluster.wait(throttled(lambda: count(rt_table) == NF_RT_PARTITIONS * half), timeout_s=NF_WAIT_S,
                     what="(c)'s first half counted")
        rc["first_half_s"] = time.perf_counter() - t
        holders: Dict[str, int] = {}
        for seg in seg0:
            for s in res.get_ideal_state(rt_physical).get(seg, {}):
                holders[s] = holders.get(s, 0) + 1
        victim = max(holders, key=lambda n: (holders[n], n))
        vsrv = cluster.server(victim).server
        added0 = st.metrics.meter("stabilizer.replicasAdded").count
        commits0 = ctrl.metrics.meter("segmentCommits").count
        cluster.faults.cut("controller", victim)  # the replies to the victim lost, its requests delivered
        cluster.wait(lambda: not vsrv.lease.held(), timeout_s=NF_WAIT_S, what="(c)'s victim fencing itself")
        blocked0 = vsrv.metrics.meter("lease.blockedCommits").count
        t_cut = time.monotonic()
        for p, path in enumerate(paths):
            with open(path, "ab") as f, open(os.path.join(stream_dir, f"p{p}.1.jsonl"), "rb") as src:
                shutil.copyfileobj(src, f)
        def online_holders(seg: str) -> List[str]:
            return sorted(s for s, v in res.get_external_view(rt_physical).get(seg, {}).items() if v == "ONLINE")

        # the commit serves from its committer at once; the victim, whose
        # replies are lost, cannot load it until the heal
        cluster.wait(lambda: all(online_holders(seg) for seg in seg0), timeout_s=NF_WAIT_S,
                     what="each partition's commit by its healthy replica")
        rc["cut_to_committed_s"] = time.monotonic() - t_cut
        st.run_once()
        rc["controller_saw_victim_alive"] = res.instances[victim].alive
        rc["no_replica_movement"] = st.metrics.meter("stabilizer.replicasAdded").count == added0
        rc["victim_blocked_commits"] = vsrv.metrics.meter("lease.blockedCommits").count - blocked0
        committers = rc["committed_by"] = {seg: online_holders(seg) for seg in seg0}
        during = cluster.query(f"SELECT count(*) FROM {rt_table}")
        rc["served_during"] = {"docs": during.num_docs_scanned, "partial": during.partial_response}
        t_heal = time.monotonic()
        cluster.faults.heal()
        cluster.wait(lambda: vsrv.lease.held() and all(
            res.get_external_view(rt_physical).get(seg, {}).get(s) == "ONLINE"
            for seg in seg0 for s in res.get_ideal_state(rt_physical)[seg]),
            timeout_s=NF_WAIT_S, what="(c)'s victim renewing and loading the committed copies")
        cluster.wait(throttled(lambda: count(rt_table) == NF_RT_PARTITIONS * NF_RT_ROWS), timeout_s=NF_WAIT_S,
                     what="(c)'s every row counted after the heal")
        rc["heal_to_caught_up_s"] = time.monotonic() - t_heal
        crcs = {}
        for seg in seg0:
            for s in cluster.server_starters:
                tdm = s.server.data_manager.table(rt_physical)
                acquired = tdm.acquire_segments([seg]) if tdm is not None else []
                try:
                    crcs.setdefault(seg, []).extend(int(d.segment.metadata.crc) for d in acquired)
                finally:
                    if acquired:
                        tdm.release_segments(acquired)
        rc["crcs"] = crcs
        rc["commits"] = ctrl.metrics.meter("segmentCommits").count - commits0
        rc["byte_identical"] = all(len(v) == NF_REPLICATION and len(set(v)) == 1 for v in crcs.values())
        rt_want = rt_wants.result()
        for name, pql in NF_QUERIES.items():
            resp = cluster.query(pql.replace("FROM lineitem", f"FROM {rt_table}"))
            if resp.partial_response:
                raise AssertionError(f"netfaults (c) {name}: partial after the heal")
            nf_check(name, resp, rt_want[name])
        rc["count"] = count(rt_table)
        time.sleep(NF_WINDOW_S)
        launched("asymmetric", since)
        rc.update(load.counts.get("asymmetric", {}))
        steps["asymmetric"] = time.perf_counter() - t
        if not (rc["controller_saw_victim_alive"] and rc["no_replica_movement"] and rc["victim_blocked_commits"] > 0
                and rc["byte_identical"] and all(len(v) == 1 and victim not in v for v in committers.values())
                and rc["commits"] == NF_RT_PARTITIONS and rc["count"] == NF_RT_PARTITIONS * NF_RT_ROWS
                and rc["failed"] == 0):
            raise AssertionError(f"netfaults (c): {rc} {load.failures} {cluster.broker.admission.snapshot()}")
        log(f"netfaults (c) asymmetric partition, replies to {victim} lost: the first halves ({half} rows a "
            f"partition) counted {rc['first_half_s']:.1f} s after the table was made; {rc['commits']} commits, one a "
            f"partition, "
            f"by its healthy replica {committers} {rc['cut_to_committed_s']:.1f} s after the second halves arrived, "
            f"the victim's commits blocked {rc['victim_blocked_commits']} times while the controller saw it alive, "
            f"no replica moved, {rc['served_during']} rows counted during the cut; after the heal the same CRC on "
            f"both replicas of each committed segment, count(*) {rc['count']} of {NF_RT_PARTITIONS * NF_RT_ROWS} "
            f"produced, q1 and distinct_price equal to their oracles; caught up {rc['heal_to_caught_up_s']:.1f} s "
            f"after the heal; offline load {load.counts.get('asymmetric')}; launches {launches['asymmetric']}")

        # (d) disaster recovery: backup while serving, the controller and its
        # property store lost, the archive restored, a new controller on the
        # same port, the servers reloaded through it
        rd = rec["disaster_recovery"] = {}
        since = mark("disaster-recovery")
        t = time.perf_counter()
        archive = os.path.join(tmp, "dr_backup.tar.gz")
        backup = create_backup(cluster.data_dir, archive)
        rd.update(backup_s=backup["backupSeconds"], archive_bytes=backup["archiveBytes"], epoch=backup["epoch"],
                  journal_bytes=backup["journalBytes"])
        ideal_before = json.dumps(res.get_ideal_state(physical), sort_keys=True)
        old_ctrl, host, port = ctrl, cluster.http.host, cluster.http.port
        t_loss = time.monotonic()
        cluster.http.stop()
        old_ctrl.stop()
        shutil.rmtree(os.path.join(cluster.data_dir, "property_store"))
        time.sleep(NF_WINDOW_S)  # the broker serves from its snapshot meanwhile
        t_restore = time.monotonic()
        restored = restore_backup(archive, cluster.data_dir)
        rd.update(restore_s=restored["restoreSeconds"], segments_verified=restored["segmentsVerified"],
                  segments_missing=restored["segmentsMissing"], segments_corrupt=restored["segmentsCorrupt"])
        gw = old_ctrl.gateway
        ctrl = cluster.controller = Controller(cluster.data_dir, lease_s=cluster.lease_s)
        ctrl.gateway.heartbeat_timeout_s, ctrl.gateway._check_interval_s = gw.heartbeat_timeout_s, gw._check_interval_s
        ctrl.stabilizer.grace_s = 0.0
        ctrl.stabilizer.rebalance_enabled = False
        cluster.http = ControllerHttpServer(ctrl, host=host, port=port)
        cluster.http.start()
        res, st = ctrl.resources, ctrl.stabilizer
        rd["controller_ready_s"] = time.monotonic() - t_restore
        mark("disaster-recovery/reload")
        serving_all = throttled(lambda: count("lineitem") == total)
        cluster.wait(lambda: converged(physical) and all(res.instances.get(s.name) is not None
                                                         and res.instances[s.name].alive
                                                         for s in cluster.server_starters)
                     and serving_all(), timeout_s=NF_WAIT_S,
                     what="every server reloaded through the restored controller")
        rd["restore_to_reloaded_s"] = time.monotonic() - t_restore
        rd["loss_to_reloaded_s"] = time.monotonic() - t_loss
        rd["epoch_after"] = ctrl.epoch
        rd["ideal_identical"] = json.dumps(res.get_ideal_state(physical), sort_keys=True) == ideal_before
        for name, pql in NF_QUERIES.items():
            nf_check(name, cluster.query(pql), wants[name])
        cluster.wait(throttled(lambda: count(rt_table) == NF_RT_PARTITIONS * NF_RT_ROWS), timeout_s=NF_WAIT_S,
                     what="(c)'s table served through the restored controller")
        try:
            old_ctrl.property_store.put("tables", "zombieWrite", {"x": 1})
            rd["zombie_write"] = "accepted"
        except StaleEpochError as e:
            rd["zombie_write"] = f"StaleEpochError: {e}"
        time.sleep(NF_WINDOW_S)
        launched("disaster-recovery", since)
        rd.update(during=load.counts.get("disaster-recovery", {}), reload=load.counts.get("disaster-recovery/reload", {}))
        counts, failures, latency = load.stop(), load.failures, load.latency()
        load = None
        steps["disaster_recovery"] = time.perf_counter() - t
        if not (rd["zombie_write"].startswith("StaleEpochError") and rd["ideal_identical"]
                and rd["segments_missing"] == [] and rd["segments_corrupt"] == [] and rd["epoch_after"] > rd["epoch"]
                and all(c["failed"] == 0 for c in counts.values())):
            raise AssertionError(f"netfaults (d): {rd} {counts} {failures} {cluster.broker.admission.snapshot()}")
        log(f"netfaults (d) disaster recovery: backup while serving {rd['backup_s']:.3f} s, archive "
            f"{rd['archive_bytes']} bytes (journal {rd['journal_bytes']} bytes, epoch {rd['epoch']}); the "
            f"controller and its property store lost, restored in {rd['restore_s']:.3f} s ({rd['segments_verified']} "
            f"store copies verified), the new controller (epoch {rd['epoch_after']}) up "
            f"{rd['controller_ready_s']:.3f} s after the restore began, every server reloaded and every row served "
            f"{rd['restore_to_reloaded_s']:.2f} s after it; answers equal to the ones before; the old controller's "
            f"write: {rd['zombie_write'][:120]}; load during {rd['during']}, reload {rd['reload']}; launches "
            f"{launches['disaster-recovery']}")
        totals = {"k1": fg.launches, "k2": vsc.launches}
        record.setdefault("paths", {})["netfaults"] = {"launches": launches, "totals": totals}
        require_launch("netfaults", totals, "k1")
        require_launch("netfaults", totals, "k2")
        rec["load"] = counts
        rec["latency_ms"] = latency
        # where a server's time goes over the phase (every sample of its phase timers)
        rec["server_ms"] = {s.name: {k: float(np.median(v)) for k in ("schedulerWait", "tierDecision", "staging",
                                                                       "planBuild", "laneWait", "planExec",
                                                                       "finalize")
                                     if (v := s.server.metrics.timer(f"phase.{k}").samples())}
                            for s in cluster.server_starters}
        rec["audit_fork_ms"] = {s.name: s.server.metrics.timer("audit.forkMs").samples()
                                for s in cluster.server_starters}
        log(f"path netfaults: launches {launches}, total {totals}; answers by step {counts}; client ms of the "
            f"complete answers by step {json.dumps({k: {m: round(x, 1) for m, x in v.items()} for k, v in latency.items()})}; "
            f"server medians {json.dumps({n: {k: round(x, 3) for k, x in v.items()} for n, v in rec['server_ms'].items()})} "
            f"ms; audit forks {json.dumps({n: [round(x, 1) for x in v] for n, v in rec['audit_fork_ms'].items()})} ms")

        # K1 and K2 at this phase's shapes (a server's replicas), in process
        rec["k1"] = k1_captured(fg, "netfaults q1 (a server's replicas)", lambda: cluster.query(NF_QUERIES["q1"]))
        rec["k2"] = k2_captured(vsc, "netfaults distinct_price (a server's replicas)",
                                lambda: cluster.query(NF_QUERIES["distinct_price"]))
    finally:
        if load is not None:
            load.stop()
        if cluster is not None:
            cluster.stop()
        if writer.poll() is None:
            writer.kill()
        writer.wait()
        if old_batch is None:
            os.environ.pop("PINOT_TPU_INGEST_BATCH_ROWS", None)
        else:
            os.environ["PINOT_TPU_INGEST_BATCH_ROWS"] = old_batch
        shutil.rmtree(tmp, ignore_errors=True)
        del segs, rt_sources
        gc.collect()
        torch.cuda.empty_cache()
    rec["wall_s"] = time.perf_counter() - t_phase
    log(f"netfaults summary on {rec['card']}: {json.dumps({k: round(v, 3) for k, v in steps.items()})}; phase "
        f"{rec['wall_s']:.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the measurements as JSON here")
    ap.add_argument("--profile", action="store_true",
                    help="also trace a few runs of each query with torch.profiler: "
                    "device time by kernel and the device's busy share")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after building the kernels and checking each against its plain "
                    "version (no queries, no timings, no result line)")
    ap.add_argument("--joins-only", action="store_true",
                    help="after the build and the kernel checks run only phase 11, the joins "
                    "(no result line)")
    ap.add_argument("--startree-only", action="store_true",
                    help="after the build and the kernel checks run only phase 12, the star-tree "
                    "tables (no result line)")
    ap.add_argument("--tiers-only", action="store_true",
                    help="after the build, the kernel checks and lineitem's datagen run only phase 13, "
                    "the postings and bit-sliced tiers (no result line)")
    ap.add_argument("--realtime-only", action="store_true",
                    help="after the build and the kernel checks run only phase 14, realtime ingestion "
                    "(no result line)")
    ap.add_argument("--residency-only", action="store_true",
                    help="after the build, the kernel checks and lineitem's datagen run only phase 15, "
                    "residency (no result line)")
    ap.add_argument("--build-only", action="store_true",
                    help="after the build, the kernel checks and lineitem's datagen run only phase 16, "
                    "the offline build path and schema evolution (no result line)")
    ap.add_argument("--warmstart-only", action="store_true",
                    help="after the build, the kernel checks and lineitem's datagen run only phase 17, "
                    "the warm start and the utilization planes (no result line)")
    ap.add_argument("--planes-only", action="store_true",
                    help="after the build, the kernel checks and lineitem's datagen run only phase 18, the "
                    "serving planes: (a) on two servers of lineitem, then phases 14 and 17 with (b) and (c) "
                    "(no result line)")
    ap.add_argument("--controller-only", action="store_true",
                    help="after the build, the kernel checks and lineitem's datagen run only phase 19, the "
                    "controller: phase 14 with its controller restart, then phase 17 hosting 18 (c) and 19 "
                    "(no result line)")
    ap.add_argument("--kafka-only", action="store_true",
                    help="after the build and the kernel checks run only phase 20, Kafka and high-level-consumer "
                    "ingestion with the hybrid quickstart (no result line)")
    ap.add_argument("--netfaults-only", action="store_true",
                    help="after the build and the kernel checks run only phase 21, the link fault plane: the "
                    "partition scenarios and disaster recovery on a networked cluster (no result line)")
    opts = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if torch.cuda.device_count() != 1:
        print(f"chip_smoke: needs exactly one visible card, found {torch.cuda.device_count()} "
              "(set CUDA_VISIBLE_DEVICES)", file=sys.stderr)
        return 2
    return run(torch.device("cuda", 0), opts)


def run(dev: torch.device, opts) -> int:
    """Every phase on ``dev`` (main() passes the one card)."""
    from pinot_tpu_torch.engine import config
    from pinot_tpu_torch.engine import hll as hll_mod
    from pinot_tpu_torch.engine import kernel as kernel_mod
    from pinot_tpu_torch.engine import kernels, packing
    from pinot_tpu_torch.engine.executor import QueryExecutor
    from pinot_tpu_torch.engine.kernels import fused_groupby as fg
    from pinot_tpu_torch.engine.kernels import value_state_counts as vsc
    from pinot_tpu_torch.engine.reduce import reduce_to_response
    from pinot_tpu_torch.pql import optimize_request, parse_pql
    from pinot_tpu_torch.tools.datagen import (
        synthetic_adevents_segment,
        synthetic_lineitem_segment,
        synthetic_mv_segment,
        tile_segments,
    )

    record = {}
    t_start = time.perf_counter()
    # every phase serves with the shadow auditor as a deployment runs it
    # (PINOT_TPU_AUDIT_SAMPLE_N, default 1-in-64); phase 18 measures its cost
    record["audit_sample_n"] = os.environ.get("PINOT_TPU_AUDIT_SAMPLE_N", "64 (the default)")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    record["card"] = card

    # 1. build every kernel: one nvcc per source, all started together. The
    # main run's tables are made meanwhile, in threads: the build only waits
    # on its nvcc processes
    def made(make):
        t = time.perf_counter()
        return make(), time.perf_counter() - t

    def lineitem():
        return [synthetic_lineitem_segment(ROWS_PER_SEGMENT, seed=11 + i, name=f"li{i}") for i in range(SEGMENTS)]

    def adevents():
        distinct = [synthetic_adevents_segment(ROWS_PER_SEGMENT, seed=7 + i, name=f"ad{i}",
                                               campaign_card=AD_CAMPAIGNS, user_card=AD_USERS)
                    for i in range(AD_DISTINCT)]
        for s in distinct:  # the per-dictionary hashing, once, outside the timed path
            hll_mod.dictionary_tables(s.column("user_id").dictionary)
        return distinct

    def mvtest():
        distinct = [synthetic_mv_segment(ROWS_PER_SEGMENT, seed=31 + i, name=f"mv{i}", cardinality=MV_CARDINALITY,
                                         mv_max=MV_MAX)
                    for i in range(MV_DISTINCT)]
        for s in distinct:  # the per-dictionary hashing, once, outside the timed path
            hll_mod.dictionary_tables(s.column("dimStrMV").dictionary)
        return distinct

    makers = {"lineitem": lineitem, "adevents": adevents, "mvtest": mvtest}
    if (opts.kernels_only or opts.joins_only or opts.startree_only or opts.realtime_only or opts.kafka_only
            or opts.netfaults_only):
        makers = {}
    elif (opts.tiers_only or opts.residency_only or opts.build_only or opts.warmstart_only or opts.planes_only
          or opts.controller_only):
        makers = {"lineitem": lineitem}
    datagen = concurrent.futures.ThreadPoolExecutor(max(1, len(makers)))
    tables = {name: datagen.submit(made, make) for name, make in makers.items()}
    datagen.shutdown(wait=False)
    t0 = time.perf_counter()
    kernels.load_all()
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.3f} s for {', '.join(kernels.KERNELS)}")
    # phase 17's compile-cache roots, given the main build's libraries
    warm_roots = []
    if not (opts.kernels_only or opts.joins_only or opts.startree_only or opts.realtime_only or opts.tiers_only
            or opts.residency_only or opts.build_only or opts.kafka_only or opts.netfaults_only):
        warm_base = tempfile.mkdtemp(prefix="pinot-compile-cache-")
        atexit.register(shutil.rmtree, warm_base, True)
        warm_roots = [os.path.join(warm_base, "cluster"), os.path.join(warm_base, "restart")]
        seed_library_roots(warm_roots)
    for name, text in kernels.build_logs.items():
        usage = sorted({ln.split("info    :")[-1].strip() for ln in text.splitlines() if "Used" in ln})
        spills = sorted({ln.strip() for ln in text.splitlines() if "spill" in ln})
        log(f"  ptxas[{name}]: {usage} {spills}")
    record["build_s"] = build_s

    # 2. each kernel against its plain version on the card
    record["k1_checks"] = {}
    for mode, dtype, rtol, atol in (
        ("x32", torch.float32, AUDIT_RTOL, AUDIT_ATOL),
        ("x64", torch.float64, X64_RTOL, X64_ATOL),
    ):
        for cname, args in with_block_tables(k1_cases(fg, dev, dtype), K1_BLOCK_CASES, dev).items():
            err, tiers = compare_k1(fg, args, rtol, atol)
            log(f"k1 check {mode} {cname}: ok in tiers {tiers}, deterministic, max_abs_err {err:.6g}")
            record["k1_checks"][f"{mode}/{cname}"] = {"max_abs_err": err, "tiers": tiers}
    record["k2_checks"] = {}
    for cname, (idx, K) in k2_cases(dev).items():
        err, tiers = compare_k2(vsc, idx, K)
        log(f"k2 check precombined {cname}: ok in tiers {tiers}, equal to torch.bincount and the "
            f"plain version, deterministic, max_abs_err {err:.6g}")
        record["k2_checks"][f"precombined/{cname}"] = {"max_abs_err": err, "tiers": tiers}
    for cname, (mode, args) in with_block_tables(k2_value_cases(dev), K2_BLOCK_CASES, dev, k2=True).items():
        tiers = compare_k2_value(vsc, mode, args)
        log(f"k2 check {cname}: ok in tiers {tiers}, bit-equal to the plain version, deterministic")
        record["k2_checks"][cname] = {"max_abs_err": 0.0, "tiers": tiers}
    check_k2_empty(vsc, dev)
    log("k2 check empty input: zero holders in every mode, no launch")
    torch.cuda.synchronize()
    if opts.kafka_only:
        record["paths"] = {}
        kafka_phase(dev, record, fg, vsc, hll_mod)
        log(f"kafka only: done in {time.perf_counter() - t_start:.1f} s")
        if opts.out:
            record["log_times"] = LOG_TIMES
            with open(opts.out, "w") as f:
                json.dump(record, f, indent=1, default=str)
        return 0
    if opts.netfaults_only:
        record["paths"] = {}
        netfaults_phase(dev, record, fg, vsc, hll_mod)
        log(f"netfaults only: done in {time.perf_counter() - t_start:.1f} s")
        if opts.out:
            record["log_times"] = LOG_TIMES
            with open(opts.out, "w") as f:
                json.dump(record, f, indent=1, default=str)
        return 0
    if opts.realtime_only:
        record["paths"] = {}
        realtime_phase(dev, record, fg, vsc, hll_mod)
        log(f"realtime only: done in {time.perf_counter() - t_start:.1f} s")
        if opts.out:
            record["log_times"] = LOG_TIMES
            with open(opts.out, "w") as f:
                json.dump(record, f, indent=1, default=str)
        return 0
    if opts.joins_only or opts.startree_only:
        if opts.joins_only:
            ssb, join_wants = join_data()
            join_phase(dev, ssb, join_wants, record, fg, vsc)
            deployed_join_phase(ssb, join_wants, record)
        else:
            startree_phase(dev, record, fg, vsc)
        log(f"{'joins' if opts.joins_only else 'startree'} only: done in {time.perf_counter() - t_start:.1f} s")
        if opts.out:
            record["log_times"] = LOG_TIMES
            with open(opts.out, "w") as f:
                json.dump(record, f, indent=1)
        return 0
    if opts.kernels_only:
        # every K1 tier at the main path's widths on data made on the card
        for pname, args in k1_probe_shapes(dev).items():
            bound, bound_by, nbytes, _ = k1_bound(args)
            for tier in k1_tiers(fg, args):
                ms, _ = cuda_ms(lambda: fg.fused_filtered_groupby_sums(**args, tier=tier), ITERS)
                log(f"k1 probe {pname} tier {tier}: {ms:.4f} ms (bound {bound:.4f} ms by {bound_by}, "
                    f"{nbytes / (ms / 1e3) / 1e12:.3f} TB/s)")
            del args
            torch.cuda.empty_cache()
        # every K2 tier at the main path's four launch shapes, and the
        # wrapper's host time per call
        for pname, (mode, args) in k2_probe_shapes(dev).items():
            bound, bound_by, nbytes, _ = k2_bound(vsc, mode, args)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(50):
                vsc.value_state(mode, **args)
            host_ms = (time.perf_counter() - t) / 50 * 1e3
            torch.cuda.synchronize()
            log(f"k2 probe {pname}: host time of the wrapper {host_ms:.4f} ms per call (enqueue only)")
            for tier in k2_tiers(vsc, mode, args):
                ms, _ = cuda_ms(lambda: vsc.value_state(mode, **args, tier=tier), ITERS)
                dev_ms = device_ms(lambda: vsc.value_state(mode, **args, tier=tier))
                kern = sum(v for k, v in dev_ms.items() if "value_state_kernel" in k)
                log(f"k2 probe {pname} ({mode}) tier {tier}: {ms:.4f} ms per call, kernel {kern:.4f} ms "
                    f"on the device, all device work {sum(dev_ms.values()):.4f} ms (bound {bound:.4f} ms by "
                    f"{bound_by}, {bound / kern:.3f} of it, {nbytes / (kern / 1e3) / 1e12:.3f} TB/s)")
            del args
            torch.cuda.empty_cache()
        # the batched kernels: ladders of members over on-card streams at
        # the main path's widths (the full run takes the lineitem ladders)
        q1 = k1_probe_shapes(dev)["q1_group_cols"]
        batched_probe("q1_group_cols_docrange", "k1", k1_ladder_members(q1, dev), fg, vsc)
        del q1
        for pname in ("distinct_price", "hll_price"):
            mode, args = k2_probe_shapes(dev)[pname]
            batched_probe(pname, "k2", k2_ladder_members(mode, args), fg, vsc, mode)
            del args
            torch.cuda.empty_cache()
        log(f"kernels only: build, checks and probes done in {time.perf_counter() - t_start:.1f} s")
        return 0

    log(f"elapsed {time.perf_counter() - t_start:.1f} s: build and kernel checks done")
    # 3. the paths at full size, x32 as the TPU served; every table is made
    # before the first timing, so no datagen thread runs beside one
    tables = {name: fut.result() for name, fut in tables.items()}
    segments, gen_s = tables["lineitem"]
    total_rows = sum(s.num_docs for s in segments)
    log(f"datagen: {SEGMENTS} x {ROWS_PER_SEGMENT} = {total_rows} rows in {gen_s:.1f} s (in a thread, beside the "
        f"build)")
    ex = QueryExecutor(device=dev, precision="x32")
    parse = lambda pql: optimize_request(parse_pql(pql))  # noqa: E731
    requests = {k: parse(v) for k, v in QUERIES.items()}
    value_requests = {k: parse(v) for k, v in VALUE_QUERIES.items()}
    torch_op_request = parse(TORCH_OP_QUERY)

    def drive(path: str, reqs: dict, segs, need: dict, host: bool = False, executor=None) -> dict:
        """One run of a path: every launch count 0 just before, read just
        after; each query must have launched each kernel in ``need``, and
        been served by the device (no ``segmentsHost`` in its cost), or
        with ``host`` by the host tier."""
        executor = executor or ex
        fg.launches = 0
        vsc.launches = 0
        kernel_mod.fused_dispatches = 0
        kernel_mod.fused_value_dispatches = 0
        per_query = {}
        out = {}
        t = time.perf_counter()
        for name, req in reqs.items():
            k1_before, k2_before = fg.launches, vsc.launches
            res = executor.execute(segs, req)
            tier = res._served_tier
            if (tier == "host") != host or bool(res.cost.get("segmentsHost")) != host:
                raise AssertionError(f"{path}/{name}: served by the {tier} tier, cost {res.cost}")
            out[name] = reduce_to_response(req, [res])
            per_query[name] = {"k1": fg.launches - k1_before, "k2": vsc.launches - k2_before}
            for kern in need.get(name, ()):
                if per_query[name][kern] < 1:
                    raise AssertionError(f"{path}/{name}: kernel {kern} was not launched")
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
        totals = {"k1": fg.launches, "k2": vsc.launches}
        log(f"path {path} (staging included): {wall_s:.1f} s, "
            f"launches per query {per_query}, total {totals}")
        record.setdefault("paths", {})[path] = {"launches": per_query, "totals": totals, "wall_s": wall_s}
        return out

    if opts.tiers_only:
        tiers_phase(dev, segments, record, fg, vsc, drive)
        record_routes(record, "lineitem", {**ZONE_QUERIES, **BSI_QUERIES}, segments, parse)
        log(f"routes: {record['routes']}")
        log(f"tiers only: done in {time.perf_counter() - t_start:.1f} s")
        if opts.out:
            record["log_times"] = LOG_TIMES
            with open(opts.out, "w") as f:
                json.dump(record, f, indent=1, default=str)
        return 0
    if opts.build_only:
        record["paths"] = {}
        build_phase(dev, segments, record, fg, vsc, hll_mod)
        log(f"build only: done in {time.perf_counter() - t_start:.1f} s")
        if opts.out:
            record["log_times"] = LOG_TIMES
            with open(opts.out, "w") as f:
                json.dump(record, f, indent=1, default=str)
        return 0
    if opts.warmstart_only:
        record["paths"] = {}
        warm_segs = segments[:WARM_SEGMENTS]
        warm_wants = {n: oracle(warm_segs, n) if n in QUERIES else value_oracle(hll_mod, warm_segs, n)
                      for n in WARM_QUERIES}
        warmstart_phase(dev, warm_segs, warm_wants, record, warm_roots, fg, vsc)
        log(f"elapsed {time.perf_counter() - t_start:.1f} s: phase 17 done")
        log(f"warm start only: done in {time.perf_counter() - t_start:.1f} s")
        if opts.out:
            record["log_times"] = LOG_TIMES
            with open(opts.out, "w") as f:
                json.dump(record, f, indent=1, default=str)
        return 0
    if opts.controller_only:
        record["paths"] = {}
        t0 = time.perf_counter()
        warm_segs = segments[:WARM_SEGMENTS]
        ctrl_wants = {n: oracle(warm_segs, n) if n in QUERIES else value_oracle(hll_mod, warm_segs, n)
                      for n in set(WARM_QUERIES) | set(CTRL_QUERIES)}
        realtime_phase(dev, record, fg, vsc, hll_mod)
        warmstart_phase(dev, warm_segs, ctrl_wants, record, warm_roots, fg, vsc)
        log(f"elapsed {time.perf_counter() - t_start:.1f} s: phase 19 done ({time.perf_counter() - t0:.1f} s with "
            f"phases 14 and 17 as its hosts)")
        log(f"controller only: done in {time.perf_counter() - t_start:.1f} s")
        if opts.out:
            record["log_times"] = LOG_TIMES
            with open(opts.out, "w") as f:
                json.dump(record, f, indent=1, default=str)
        return 0
    if opts.planes_only:
        record["paths"] = {}
        t0 = time.perf_counter()
        plane_wants = {n: oracle(segments, n) if n in QUERIES else value_oracle(hll_mod, segments, n)
                       for n in PLANES_QUERIES}
        warm_segs = segments[:WARM_SEGMENTS]
        warm_wants = {n: oracle(warm_segs, n) if n in QUERIES else value_oracle(hll_mod, warm_segs, n)
                      for n in WARM_QUERIES}
        half = len(segments) // 2
        plane_wants.update(sel_top=selection_oracle(segments, "sel_top"),
                           pairs_distinct=served_distinct_oracle([segments[:half], segments[half:]]))
        fleet = _Fleet(dev, {"server0": segments[:half], "server1": segments[half:]})
        try:
            for name in PLANES_QUERIES:
                check_served(name, fleet.broker.handle_pql({**QUERIES, **VALUE_QUERIES}[name]), plane_wants[name])
            planes_phase(dev, fleet, segments, plane_wants, record, fg, vsc)
        finally:
            fleet.close()
            for server in fleet.servers.values():
                server.executor.free_staging()
            del fleet
            torch.cuda.empty_cache()
        realtime_phase(dev, record, fg, vsc, hll_mod)
        warmstart_phase(dev, warm_segs, warm_wants, record, warm_roots, fg, vsc)
        log(f"elapsed {time.perf_counter() - t_start:.1f} s: phase 18 done ({time.perf_counter() - t0:.1f} s with "
            f"phases 14 and 17 as its hosts)")
        log(f"planes only: done in {time.perf_counter() - t_start:.1f} s")
        if opts.out:
            record["log_times"] = LOG_TIMES
            with open(opts.out, "w") as f:
                json.dump(record, f, indent=1, default=str)
        return 0
    if opts.residency_only:
        record["paths"] = {}
        res_wants = {n: oracle(segments, n) if n in QUERIES else value_oracle(hll_mod, segments, n)
                     for n in RES_QUERIES}
        residency_phase(dev, segments, record, fg, vsc, res_wants)
        log(f"residency only: done in {time.perf_counter() - t_start:.1f} s")
        if opts.out:
            record["log_times"] = LOG_TIMES
            with open(opts.out, "w") as f:
                json.dump(record, f, indent=1, default=str)
        return 0

    # 3a. slice 1: Q1, Q3, RANGE through K1's fused route, which combines
    # the group key inside the kernel: no torch-op key combine may run
    def no_key_combine(*a, **k):
        raise AssertionError("the fused route combined the group key with torch ops")

    real_group_keys, kernel_mod._group_keys = kernel_mod._group_keys, no_key_combine
    try:
        responses = drive("q1_q3_range", requests, segments, {n: ("k1",) for n in QUERIES})
    finally:
        kernel_mod._group_keys = real_group_keys
    if kernel_mod.fused_dispatches != len(QUERIES):
        raise AssertionError(f"{kernel_mod.fused_dispatches} fused dispatches for {len(QUERIES)} queries")
    record["oracle_max_rel_err"] = {}
    wants = {}  # the host oracles, kept for the serving phase
    # the float64 oracles of phases 3a-3c in threads (numpy releases the
    # interpreter), each checked below in turn
    oracles = concurrent.futures.ThreadPoolExecutor(4)
    pending = {n: oracles.submit(oracle, segments, n) for n in (*QUERIES, "torch_op")}
    pending.update({n: oracles.submit(value_oracle, hll_mod, segments, n) for n in VALUE_QUERIES})
    for name in QUERIES:
        wants[name] = pending[name].result()
        worst = check_response(responses[name], wants[name])
        log(f"oracle {name}: ok (max rel sum err {worst:.3g})")
        record["oracle_max_rel_err"][name] = worst

    # 3b. the value-state queries, every one through K2 on the fused value
    # route: K2 combines the index (and K1 the group key) inside the
    # kernel, so neither torch-op combine may run
    def no_index_combine(*a, **k):
        raise AssertionError("the fused value route combined the index with torch ops")

    real_combine, vsc.combine_index = vsc.combine_index, no_index_combine
    kernel_mod._group_keys = no_key_combine
    try:
        value_responses = drive("value_state", value_requests, segments,
                                {n: ("k2",) for n in VALUE_QUERIES})
    finally:
        kernel_mod._group_keys, vsc.combine_index = real_group_keys, real_combine
    if kernel_mod.fused_value_dispatches != len(VALUE_QUERIES):
        raise AssertionError(f"{kernel_mod.fused_value_dispatches} fused value dispatches for "
                             f"{len(VALUE_QUERIES)} queries")
    for name in VALUE_QUERIES:
        wants[name] = pending[name].result()
        check_value_response(value_responses[name], wants[name])
        log(f"oracle {name}: ok, exact ({value_responses[name].aggregation_results[0].to_json()})"[:400])

    # 3c. the torch-op route: group sums through K1 over the mask, twice
    first = ex.execute(segments, torch_op_request)
    drive("torch_op", {"torch_op": torch_op_request}, segments, {"torch_op": ("k1",)})
    second = ex.execute(segments, torch_op_request)
    if partials_of(first) != partials_of(second):
        raise AssertionError("torch_op: two runs differ")
    wants["torch_op"] = pending["torch_op"].result()
    torch_op_response = reduce_to_response(torch_op_request, [second])
    worst = check_response(torch_op_response, wants["torch_op"])
    log(f"torch_op: two runs bit-identical; oracle ok (max rel sum err {worst:.3g})")
    record["oracle_max_rel_err"]["torch_op"] = worst

    # 3d. the north-star HLL group-by: HLL streams, the sort lowering
    ad_distinct, gen_s = tables["adevents"]
    ad_segments = tile_segments(ad_distinct, SEGMENTS)
    log(f"datagen + user hashing: {AD_DISTINCT} distinct x {ROWS_PER_SEGMENT} rows tiled to "
        f"{SEGMENTS} segments in {gen_s:.1f} s (in a thread, beside the build)")
    ns_request = parse(NORTH_STAR)
    # north_star's and the pairs' oracles in the threads, beside the paths
    pending["north_star"] = oracles.submit(north_star_oracle, hll_mod, ad_segments)
    for name in PAIR_QUERIES:
        pending[name] = oracles.submit(pair_oracle, hll_mod, ad_segments if name in AD_QUERIES else segments, name)
    # phase 7's host oracles and phase 10's zone oracles too, beside phases 3f-9
    pending["reach_overflow"] = oracles.submit(pair_oracle, hll_mod, ad_segments, "reach_overflow")
    pending["host_groups"] = oracles.submit(host_groups_oracle, segments)
    pending["zone_in"] = oracles.submit(oracle, segments, "zone_in")
    pending["zone_distinct"] = oracles.submit(value_oracle, hll_mod, segments, "zone_distinct")
    # phase 17's (and 19's) over its segments
    warm_pending = {n: oracles.submit(oracle, segments[:WARM_SEGMENTS], n) if n in QUERIES
                    else oracles.submit(value_oracle, hll_mod, segments[:WARM_SEGMENTS], n) for n in WARM_QUERIES}
    ns = drive("north_star", {"north_star": ns_request}, ad_segments, {"north_star": ("k1",)})
    if record["paths"]["north_star"]["totals"]["k2"]:
        raise AssertionError("north_star: the sort lowering launched the value-state kernel")
    ns_want = pending["north_star"].result()
    check_value_response(ns["north_star"], ns_want)
    log("oracle north_star: ok, exact")

    def segs_of(name: str):
        return ad_segments if name in AD_QUERIES else segments

    # 3e. selection: the torch-op route (a top-k over a packed key with the
    # doc id folded in, or stable sorts) over the evaluated mask, no fused
    # route; every row against the host's pick
    sel_requests = {k: parse(v) for k, v in SELECTION_QUERIES.items()}
    selected = drive("selection", sel_requests, segments, {})
    if kernel_mod.fused_dispatches or kernel_mod.fused_value_dispatches:
        raise AssertionError("selection: a query took a fused route")
    for name in SELECTION_QUERIES:
        cols, rows = wants[name] = selection_oracle(segments, name)
        got = selected[name].selection_results
        if got.columns != cols or got.rows != rows:
            raise AssertionError(f"{name}: {got.columns} {got.rows} != oracle {cols} {rows}")
        log(f"oracle {name}: ok, exact, {len(rows)} rows, first {got.to_json()['results'][0]}"[:400])

    # 3f. exact distinct over (group, value) pairs: the pairs sort-dedup
    # (torch ops), the group counts through K1 over the evaluated mask, no
    # fused route and no K2; the unique pairs beside the device buffer
    pair_requests = {k: parse(v) for k, v in PAIR_QUERIES.items()}
    pair_stats = []
    real_reduce = kernel_mod._reduce_distinct_pairs

    def counting_reduce(value):
        out = real_reduce(value)
        pair_stats.append((int(out[3]), int(out[4])))
        return out

    kernel_mod._reduce_distinct_pairs = counting_reduce
    try:
        paired = {}
        for path, segs in (("pairs_lineitem", segments), ("pairs_adevents", ad_segments)):
            reqs = {k: r for k, r in pair_requests.items() if segs_of(k) is segs}
            paired.update(drive(path, reqs, segs, {n: ("k1",) for n in reqs}))
            if kernel_mod.fused_dispatches or kernel_mod.fused_value_dispatches:
                raise AssertionError(f"{path}: a query took a fused route")
            if record["paths"][path]["totals"]["k2"]:
                raise AssertionError(f"{path}: the pair path launched the value-state kernel")
    finally:
        kernel_mod._reduce_distinct_pairs = real_reduce
    record["pairs_unique"] = {}
    for (name, resp), (n_unique, kept) in zip(paired.items(), pair_stats):
        want, want_unique, want_kept = wants[name] = pending[name].result()
        check_value_response(resp, want)
        if (n_unique, kept) != (want_unique, want_kept):
            raise AssertionError(f"{name}: {n_unique} unique of {kept} kept pairs, oracle "
                                 f"{want_unique} of {want_kept}")
        log(f"oracle {name}: ok, exact; {kept} kept pairs, {n_unique} unique (the host's count too) "
            f"of DISTINCT_PAIR_CAP {config.DISTINCT_PAIR_CAP}")
        record["pairs_unique"][name] = {"kept": kept, "unique": n_unique, "cap": config.DISTINCT_PAIR_CAP}
    log(f"staged on the card: {ex.staged_bytes()} bytes")
    record.update(staged_bytes=ex.staged_bytes(), total_rows=total_rows)

    log(f"elapsed {time.perf_counter() - t_start:.1f} s: phases 3a-3f done")
    # 4. timing: whole queries (with the host's finalize and broker reduce,
    # and the bytes of the one device-to-host copy), then each kernel at
    # each query's shapes
    all_requests = {**requests, **value_requests, "torch_op": torch_op_request,
                    "north_star": ns_request, **sel_requests, **pair_requests}
    host = {"finalize": [], "reduce": [], "d2h": 0}
    real_finalize, real_dispatch = ex._finalize, packing.dispatch_packed

    def timed_finalize(*a, **k):
        t = time.perf_counter()
        out = real_finalize(*a, **k)
        host["finalize"].append(time.perf_counter() - t)
        return out

    def measured_dispatch(outs):
        handle = real_dispatch(outs)
        host["d2h"] = handle.nbytes
        return handle

    def timed_query(req, segs):
        def fn():
            res = ex.execute(segs, req)
            t = time.perf_counter()
            reduce_to_response(req, [res])
            host["reduce"].append(time.perf_counter() - t)
        return fn

    record["query_ms"], record["query_host"] = {}, {}
    ex._finalize, packing.dispatch_packed = timed_finalize, measured_dispatch
    try:
        for name, req in all_requests.items():
            host.update(finalize=[], reduce=[])
            ms, _ = cuda_ms(timed_query(req, segs_of(name)), QUERY_ITERS)
            fin_ms = float(np.median(host["finalize"])) * 1e3
            red_ms = float(np.median(host["reduce"])) * 1e3
            log(f"query {name}: {ms:.3f} ms median of {QUERY_ITERS}, {total_rows / (ms / 1e3):.4g} rows/s; host "
                f"finalize {fin_ms:.3f} ms + broker reduce {red_ms:.3f} ms (medians); D2H {host['d2h']} bytes")
            record["query_ms"][name] = ms
            record["query_host"][name] = {"finalize_ms": fin_ms, "reduce_ms": red_ms, "d2h_bytes": host["d2h"]}
    finally:
        ex._finalize, packing.dispatch_packed = real_finalize, real_dispatch
    if opts.profile:
        record["profile"] = {}
        for name, req in all_requests.items():
            segs = segs_of(name)
            record["profile"][name] = profile_query(
                lambda: reduce_to_response(req, [ex.execute(segs, req)]), name
            )
            kernel_names = record["profile"][name]["device_ms_per_query_by_kernel"]
            if any("fused_groupby_reduce" in kn for kn in kernel_names):
                raise AssertionError(f"{name}: K1 ran a second reduce kernel")

    # K1 at each of its seven launch shapes on the main path: the fused
    # route's (the key combined in the kernel) and the torch-op route's
    # group counts and sums over the evaluated mask
    captured = {}
    record["k1"] = {}
    k1_queries = {**requests, "hll_groupby": value_requests["hll_groupby"],
                  "pct_quantity": value_requests["pct_quantity"], "torch_op": torch_op_request,
                  "north_star": ns_request, "pairs_pct": pair_requests["pairs_pct"],
                  "reach_exact": pair_requests["reach_exact"]}
    names = ("filter_fwd", "match", "num_docs", "group_keys", "value_fwds", "value_dicts", "capacity")
    for name, req in k1_queries.items():
        captured.clear()
        restore = (_capture(fg, "fused_filtered_groupby_sums", captured, "k1"),
                   _capture(kernel_mod, "_group_keys", captured, "keys"))
        try:
            ex.execute(segs_of(name), req)
        finally:
            fg.fused_filtered_groupby_sums, kernel_mod._group_keys = restore
        a, k = captured["k1"]
        args = {**dict(zip(names, a)), **k}
        # the fused routes (and the torch-op route, whose K1 launch takes
        # the group columns too) hand K1 the group columns; only the fused
        # routes build no precombined key at all
        fused = name in QUERIES or name in ("hll_groupby", "pct_quantity")
        if args["group_keys"] is not None or (fused and "keys" in captured):
            raise AssertionError(f"{name}: the route did not hand K1 the group columns")
        err, tiers = compare_k1(fg, args, AUDIT_RTOL, AUDIT_ATOL)
        tier = fg.choose_tier(*k1_shape(fg, args))
        k_ms, _ = cuda_ms(lambda: fg.fused_filtered_groupby_sums(**args), ITERS)
        tier_ms = {t: cuda_ms(lambda: fg.fused_filtered_groupby_sums(**args, tier=t), ITERS)[0]
                   for t in tiers}
        p_ms, _ = cuda_ms(lambda: fg.fused_filtered_groupby_sums_reference(**args), 1, warmup=0)
        key_ms = None
        if "keys" in captured:  # the torch-op route still combines its key (min/max need it)
            ka, kk = captured["keys"]
            key_ms, _ = cuda_ms(lambda: restore[1](*ka, **kk), ITERS)
        matched = int(fg.fused_filtered_groupby_sums(**args)[0])
        bound, bound_by, nbytes, ops = k1_bound(args, matched)
        read_ms = None
        if name == "q1":  # the practical ceiling: one plain streaming read of a float32 stream
            raw = args["value_raws"][0]
            read_ms, _ = cuda_ms(lambda: raw.sum(), ITERS)
            raw_bytes = raw.numel() * raw.element_size()
            log(f"k1 q1 yardstick: torch.sum over one {raw_bytes} B float32 stream {read_ms:.4f} ms, "
                f"{raw_bytes / (read_ms / 1e3) / 1e12:.3f} TB/s")
        key_form = ("group_cols " + "+".join(str(g.dtype).replace("torch.", "") for g in args["group_cols"])
                    + ("" if fused else ", key combine still run for min/max, the HLL sort or the pairs"))
        log(f"k1 {name} ({key_form}, K={args['capacity']}, nv={len(args['value_dicts'])}, tier {tier}, "
            f"{matched} rows matched): {k_ms:.4f} ms (bound {bound:.4f} ms by {bound_by}: {nbytes} bytes, {ops} operations; "
            f"{bound / k_ms:.3f} of the bound, {nbytes / (k_ms / 1e3) / 1e12:.3f} TB/s), tiers "
            f"{ {t: round(v, 4) for t, v in tier_ms.items()} }, plain {p_ms:.4f} ms, key combine "
            f"{'none (in the kernel)' if key_ms is None else f'{key_ms:.4f} ms'}, max_abs_err {err:.6g}")
        record["k1"][name] = dict(ms=k_ms, tier=tier, tier_ms=tier_ms, plain_ms=p_ms, bound_ms=bound,
                                  bound_by=bound_by, bytes=nbytes, operations=ops, key_combine_ms=key_ms,
                                  key_form=key_form, max_abs_err=err, stream_read_ms=read_ms)

    # K2 at each of its four launch shapes on the main path, as the fused
    # value route hands it the streams; beside it the torch-op combine the
    # route no longer runs, and over that combined index the precombined
    # form and torch.bincount
    record["k2"] = {}
    for name, req in value_requests.items():
        captured.clear()
        restore = _capture(vsc, "value_state", captured, "k2")
        try:
            ex.execute(segments, req)
        finally:
            vsc.value_state = restore
        (mode, *rest), kw = captured["k2"]
        args = {**dict(zip(("num_docs", "values"), rest)), **kw}
        tiers = compare_k2_value(vsc, mode, args)
        tier = vsc.choose_tier(mode, vsc.index_space(mode, args["capacity"], args.get("width")),
                               vsc.shared_table_bytes(k2_tables(args)),
                               args["match"].shape[-1] if args.get("match") is not None else 0)
        # per-call CUDA events, as for K1 (the wrapper's host work up to
        # the launch included); beside them the device time (zero fill,
        # kernel, finish) from torch.profiler, by which the tiers compare
        k_ms, _ = cuda_ms(lambda: vsc.value_state(mode, **args), ITERS)
        dev_ms = sum(device_ms(lambda: vsc.value_state(mode, **args)).values())
        tier_ms = {t: sum(device_ms(lambda: vsc.value_state(mode, **args, tier=t)).values()) for t in tiers}
        p_ms, _ = cuda_ms(lambda: vsc.value_state_reference(mode, **args), 1, warmup=0)  # ITERS before phase 14
        comb_ms, _ = cuda_ms(lambda: vsc.combine_index(mode, **args), ITERS)
        idx, K, _ = vsc.combine_index(mode, **args)
        counts = vsc.value_state_counts(idx, K)
        if not torch.equal(vsc.holder_from_counts(mode, counts), vsc.value_state(mode, **args)[1]):
            raise AssertionError(f"k2 {name}: the fused holder differs from the precombined counts")
        pre_ms, _ = cuda_ms(lambda: vsc.value_state_counts(idx, K), ITERS)
        pre_dev_ms = sum(device_ms(lambda: vsc.value_state_counts(idx, K)).values())
        lib_ms, _ = cuda_ms(lambda: torch.bincount(idx.reshape(-1), minlength=K + 1)[:K], ITERS)
        matched = int(vsc.value_state(mode, **args)[0])
        bound, bound_by, nbytes, ops = k2_bound(vsc, mode, args, matched)
        old_bound = k2_index_bound(idx, K)[0]
        del idx, counts
        log(f"k2 {name} ({mode}, K={K}, tier {tier}, {matched} rows matched): {k_ms:.4f} ms per call, "
            f"{dev_ms:.4f} ms on the device "
            f"(bound {bound:.4f} ms by {bound_by}: {nbytes} bytes, {ops} operations; per call {bound / k_ms:.3f} "
            f"of it, on the device {bound / dev_ms:.3f}, {nbytes / (dev_ms / 1e3) / 1e12:.3f} TB/s; old bound "
            f"over the combined index {old_bound:.4f} ms, {old_bound / dev_ms:.3f} of the device time), tiers "
            f"on the device { {t: round(v, 4) for t, v in tier_ms.items()} }, plain {p_ms:.4f} ms, plain int64 "
            f"torch-op combine {comb_ms:.4f} ms (not run by the route), precombined form {pre_ms:.4f} ms per "
            f"call, {pre_dev_ms:.4f} ms on the device, torch.bincount {lib_ms:.4f} ms, max_abs_err 0")
        record["k2"][name] = dict(mode=mode, K=K, tier=tier, tier_ms=tier_ms, ms=k_ms, device_ms=dev_ms,
                                  plain_ms=p_ms, library_ms=lib_ms, precombined_ms=pre_ms,
                                  precombined_device_ms=pre_dev_ms, combine_ms=comb_ms, bound_ms=bound,
                                  old_bound_ms=old_bound, bound_by=bound_by, bytes=nbytes, operations=ops,
                                  max_abs_err=0.0)
        del args
        torch.cuda.empty_cache()

    # the pair sort-dedup at each pair query's shapes: its time against a
    # byte bound (each kept pair's 8-byte key written and read once), and
    # the fetch of its buffers cut to n_unique (the port's) beside the
    # whole DISTINCT_PAIR_CAP buffers (the reference's)
    record["pairs"] = {}
    for name, req in pair_requests.items():
        captured.clear()
        restore = _capture(kernel_mod, "_reduce_distinct_pairs", captured, "pairs")
        try:
            ex.execute(segs_of(name), req)
        finally:
            kernel_mod._reduce_distinct_pairs = restore
        (value,), _ = captured["pairs"]
        out = restore(value)
        n_unique, kept = int(out[3]), int(out[4])
        red_ms, _ = cuda_ms(lambda: restore(value), ITERS)
        red_dev = device_ms(lambda: restore(value), expect="Sort")
        bound = kept * 16 / HBM_BYTES_PER_S * 1e3
        cap = config.DISTINCT_PAIR_CAP
        padded = tuple(torch.zeros(cap, dtype=torch.int32, device=dev) for _ in range(3)) + tuple(out[3:])
        exact_ms, _ = cuda_ms(lambda: packing.fetch_packed(out), ITERS)
        cap_ms, _ = cuda_ms(lambda: packing.fetch_packed(padded), ITERS)
        rows = value[0].numel()
        top = sorted(red_dev.items(), key=lambda kv: -kv[1])[:4]
        log(f"pairs {name}: sort-dedup of {kept} kept pairs (of {rows} rows, {n_unique} unique) "
            f"{red_ms:.4f} ms per call, {sum(red_dev.values()):.4f} ms on the device (bound {bound:.4f} ms by "
            f"bytes, {bound / red_ms:.3f} of it per call); top device work "
            f"{ {k[:60]: round(v, 4) for k, v in top} }; fetch cut to n_unique "
            f"({3 * 4 * n_unique + 8} B) {exact_ms:.4f} ms vs whole buffers ({3 * 4 * cap + 8} B) {cap_ms:.4f} ms")
        record["pairs"][name] = dict(kept=kept, unique=n_unique, rows=rows, ms=red_ms,
                                     device_ms=sum(red_dev.values()), device_by_kernel=red_dev, bound_ms=bound,
                                     fetch_exact_ms=exact_ms, fetch_cap_ms=cap_ms)
        del value, out, padded
        torch.cuda.empty_cache()

    # the zone-map decision's host time (candidate map, window, block table)
    # on the full-scan queries, which pay it before they run whole
    def decision_ms(executor, reqs: dict, label: str) -> None:
        real = executor._block_skip_ids
        times = []

        def timed(*a):
            t = time.perf_counter()
            rows = real(*a)
            times.append(((time.perf_counter() - t) * 1e3, rows is not None))
            return rows

        executor._block_skip_ids = timed
        try:
            for name, req in reqs.items():
                times.clear()
                for _ in range(ITERS):
                    executor.execute(segments, req)
                ms = float(np.median([t for t, _ in times]))
                engaged = times[-1][1]
                record.setdefault("zone_decision", {})[name] = {"ms": ms, "block_path": engaged}
                log(f"zone decision {name} ({label}): {ms:.4f} ms on the host, median of {ITERS}; block path "
                    f"{'engaged' if engaged else 'not engaged (full scan)'}")
        finally:
            executor._block_skip_ids = real

    decision_ms(ex, {**requests, **value_requests}, "full scans")

    log(f"elapsed {time.perf_counter() - t_start:.1f} s: phase 4 timings done")
    # 4b. the batched kernels over lineitem ladders: same-plan queries at
    # distinct literals, each member's K1 / K2 arguments as the executor
    # hands them over (full scans: the batching tier takes no block path)
    record["batched"] = {}
    ladders = {
        "q1_dates": ("k1", [q1_at(d) for d in BATCH_DATES]),
        "range_qty": ("k1", [range_at(t) for t in QTY_LADDER]),
        "distinct_price_qty": ("k2", [distinct_at(t) for t in QTY_LADDER]),
        "hll_price_modes": ("k2", [hll_at(SHIP_MODES[i % len(SHIP_MODES)]) for i in range(max(BATCH_SIZES))]),
    }
    ex.zone_maps = False
    try:
        for label, (kind, pqls) in ladders.items():
            members, mode = [], None
            for pql in pqls:
                captured.clear()
                mod, fname = (fg, "fused_filtered_groupby_sums") if kind == "k1" else (vsc, "value_state")
                restore = _capture(mod, fname, captured, kind)
                try:
                    ex.execute(segments, parse(pql))
                finally:
                    setattr(mod, fname, restore)
                if kind == "k1":
                    a, k = captured["k1"]
                    members.append({**dict(zip(names, a)), **k})
                else:
                    (mode, *rest), kw = captured["k2"]
                    members.append({**dict(zip(("num_docs", "values"), rest)), **kw})
            record["batched"][label] = batched_probe(label, kind, members, fg, vsc, mode)
            record["batched"][label]["kind"] = kind
            del members
            torch.cuda.empty_cache()
    finally:
        ex.zone_maps = True

    log(f"elapsed {time.perf_counter() - t_start:.1f} s: phase 4b done")
    # 4c. the chunked phase: the whole table past a per-dispatch row budget
    # of 2^26 rows, two chunks of 8 segments; each answer against its
    # oracle, and against the unchunked run (counts exact; sums
    # bit-identical, or within the audit band)
    chunk_requests = {"q1": requests["q1"], "torch_op": torch_op_request,
                      "hll_groupby": value_requests["hll_groupby"], "pct_quantity": value_requests["pct_quantity"]}
    unchunked = {"q1": responses["q1"], "torch_op": torch_op_response,
                 "hll_groupby": value_responses["hll_groupby"], "pct_quantity": value_responses["pct_quantity"]}
    record["chunked"] = {}
    # half the table a dispatch: 2^26 rows at the full size
    budget, config.CHUNK_ROWS = config.CHUNK_ROWS, SEGMENTS * ROWS_PER_SEGMENT // 2
    try:
        c0 = kernel_mod.chunked_dispatches
        chunked = drive("chunked", chunk_requests, segments, {"q1": ("k1",), "torch_op": ("k1",),
                                                              "hll_groupby": ("k1", "k2"),
                                                              "pct_quantity": ("k1", "k2")})
        if kernel_mod.chunked_dispatches - c0 != len(chunk_requests):
            raise AssertionError(f"chunked: {kernel_mod.chunked_dispatches - c0} chunked dispatches for "
                                 f"{len(chunk_requests)} queries")
        for name, resp in chunked.items():
            if name in ("q1", "torch_op"):
                check_response(resp, wants[name])
            else:
                check_value_response(resp, wants[name])
            same = json.dumps([a.to_json() for a in resp.aggregation_results], sort_keys=True) == \
                json.dumps([a.to_json() for a in unchunked[name].aggregation_results], sort_keys=True)
            if not same:
                if name not in ("q1", "torch_op"):
                    raise AssertionError(f"chunked {name}: the value states differ from the unchunked run")
                check_response(resp, response_as_want(unchunked[name]))
            ms, _ = cuda_ms(lambda: reduce_to_response(chunk_requests[name], [ex.execute(segments, chunk_requests[name])]),
                            QUERY_ITERS)
            launched = record["paths"]["chunked"]["launches"][name]
            record["chunked"][name] = dict(ms=ms, unchunked_ms=record["query_ms"][name], launches=launched,
                                           vs_unchunked="bit-identical" if same else "within the audit band")
            log(f"chunked {name}: oracle ok; {'bit-identical to' if same else 'within the audit band of'} the "
                f"unchunked run; {ms:.3f} ms median of {QUERY_ITERS} (unchunked {record['query_ms'][name]:.3f}); "
                f"launches {launched} over 2 chunks")
    finally:
        config.CHUNK_ROWS = budget

    log(f"elapsed {time.perf_counter() - t_start:.1f} s: phase 4c done")
    # 7. the host tier, timed apart from the device phases: host_groups
    # leaves the device before anything is staged; reach_overflow runs on
    # the device (K1 for the group counts, the pair reduce) and the host
    # finishes exactly past DISTINCT_PAIR_CAP unique pairs
    host_requests = {k: parse(v) for k, v in HOST_QUERIES.items()}
    staged_before = set(ex._staged)
    hosted = drive("host_groups", {"host_groups": host_requests["host_groups"]}, segments, {}, host=True)
    if set(ex._staged) != staged_before:
        raise AssertionError("host_groups: the executor staged a table for a query the host serves")
    if record["paths"]["host_groups"]["totals"] != {"k1": 0, "k2": 0}:
        raise AssertionError("host_groups: a kernel launched for a query the host serves")
    sums, counts, ship, receipt = pending["host_groups"].result()
    ar_sum, ar_cnt = hosted["host_groups"].aggregation_results
    worst = max(check_top(ar_sum, host_groups_want(ar_sum, sums, counts, ship, receipt), exact=False),
                check_top(ar_cnt, host_groups_want(ar_cnt, counts, counts, ship, receipt), exact=True))
    log(f"oracle host_groups: ok ({int(np.count_nonzero(counts))} groups; max rel sum err {worst:.3g})")
    record["oracle_max_rel_err"]["host_groups"] = worst
    overflow = []
    kernel_mod._reduce_distinct_pairs = lambda v: overflow.append(real_reduce(v)) or overflow[-1]
    try:
        hosted.update(drive("reach_overflow", {"reach_overflow": host_requests["reach_overflow"]},
                            ad_segments, {"reach_overflow": ("k1",)}, host=True))
    finally:
        kernel_mod._reduce_distinct_pairs = real_reduce
    (out,) = overflow
    n_unique, kept = int(out[3]), int(out[4])
    want, want_unique, want_kept = pending["reach_overflow"].result()
    if (n_unique, kept) != (want_unique, want_kept) or n_unique <= config.DISTINCT_PAIR_CAP:
        raise AssertionError(f"reach_overflow: {n_unique} unique of {kept} kept pairs, oracle "
                             f"{want_unique} of {want_kept}, cap {config.DISTINCT_PAIR_CAP}")
    check_value_response(hosted["reach_overflow"], want)
    log(f"oracle reach_overflow: ok, exact; the device counted {kept} kept pairs, {n_unique} unique "
        f"(the host's count too) past DISTINCT_PAIR_CAP {config.DISTINCT_PAIR_CAP}; the host finished")
    record["pairs_unique"]["reach_overflow"] = {"kept": kept, "unique": n_unique, "cap": config.DISTINCT_PAIR_CAP}
    del out, overflow
    record["host_ms"] = {}
    for name, req in host_requests.items():
        # the path's run above is the first timed run (nothing of it was
        # staged then: host_groups stages nothing, reach_overflow's table
        # is reach_exact's, staged in phase 3f)
        segs = ad_segments if name == "reach_overflow" else segments
        walls, host_ms = [record["paths"][name]["wall_s"] * 1e3], [hosted[name].cost["hostMs"]]
        seg_host = hosted[name].cost["segmentsHost"]
        for _ in range(HOST_ITERS - 1):
            t = time.perf_counter()
            res = ex.execute(segs, req)
            reduce_to_response(req, [res])
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
            host_ms.append(res.cost["hostMs"])
            seg_host = res.cost["segmentsHost"]
        wall, hms = float(np.median(walls)), float(np.median(host_ms))
        log(f"query {name}: {wall:.3f} ms median of {HOST_ITERS} (host clock), hostMs {hms:.3f} (median), "
            f"segmentsHost {seg_host}, {total_rows / (wall / 1e3):.4g} rows/s")
        record["host_ms"][name] = {"ms": wall, "host_ms": hms, "segments_host": seg_host, "runs": walls}
    if opts.profile:
        for name, req in host_requests.items():
            segs = ad_segments if name == "reach_overflow" else segments
            record["profile"][name] = profile_query(
                lambda: reduce_to_response(req, [ex.execute(segs, req)]), name, runs=1)

    log(f"elapsed {time.perf_counter() - t_start:.1f} s: phase 7 done")
    # 8. multi-value columns: the card's memory goes to the mvtest table
    record["staged_bytes_by_table"] = {"lineitem+adevents": ex.staged_bytes()}
    record["phases_1_7_residency"] = ex.residency.snapshot()
    log(f"residency of phases 1-7's executor (default caps): {json.dumps(record['phases_1_7_residency'])}")
    ex.free_staging()
    torch.cuda.empty_cache()
    mv_distinct, gen_s = tables["mvtest"]
    mv_segments = tile_segments(mv_distinct, MV_SEGMENTS)
    mv_rows = MV_SEGMENTS * ROWS_PER_SEGMENT
    entries = {c: sum(int(s_.column(c).mv_offsets[-1]) for s_ in mv_segments) for c in ("dimStrMV", "dimIntMV")}
    log(f"datagen mvtest: {MV_DISTINCT} distinct x {ROWS_PER_SEGMENT} rows tiled to {MV_SEGMENTS} segments, "
        f"MV entries {entries} in {gen_s:.1f} s (in a thread, beside the build)")
    values = mv_query_values(mv_segments)
    mv_requests = {k: parse(v.format(**values)) for k, v in MV_QUERIES.items()}
    # past the postings tier: mv_filter's three-value IN would be answered
    # from host postings (phase 13's routes line), and this phase holds K1 at
    # its shape
    mv_ex = QueryExecutor(device=dev, precision="x32", postings=False)
    mv_need = {"mv_filter": ("k1",), "mv_groupby": ("k1",), "mv_aggs": ("k2",), "mv_grouped_state": ("k2",)}
    mv_wants = {n: oracles.submit(mv_oracle, hll_mod, mv_distinct, MV_SEGMENTS // MV_DISTINCT, n, values)
                for n in MV_QUERIES}  # in the threads, beside the path
    oracles.shutdown(wait=False)
    mv_answers = drive("mv", mv_requests, mv_segments, mv_need, executor=mv_ex)
    if kernel_mod.fused_dispatches or kernel_mod.fused_value_dispatches:
        raise AssertionError("mv: a query took a fused route")
    for name in MV_QUERIES:
        worst = check_mv_response(mv_answers[name], mv_wants[name].result())
        log(f"oracle {name}: ok (max rel sum err {worst:.3g}); "
            f"{json.dumps(mv_answers[name].aggregation_results[0].to_json())[:300]}")
        record["oracle_max_rel_err"][name] = worst
    # what the mvtest tables hold on the card, by column and role
    roles = {}
    for st in mv_ex._staged.values():
        for cname, sc in st.columns.items():
            for role in ("fwd", "dict_vals", "raw", "gfwd", "mv", "mv_counts", "mv_raw"):
                t = getattr(sc, role)
                if t is not None:
                    roles[f"{cname}.{role}"] = (str(t.dtype).replace("torch.", ""), tuple(t.shape),
                                                t.numel() * t.element_size())
    record["staged_bytes_by_table"]["mvtest"] = mv_ex.staged_bytes()
    log(f"staged on the card: lineitem + adevents {record['staged_bytes_by_table']['lineitem+adevents']} bytes "
        f"(freed before mvtest); mvtest {mv_ex.staged_bytes()} bytes over {len(mv_ex._staged)} staged tables "
        f"(one per query's column set); by column and role (dtype, shape, bytes): {roles}")
    record["mvtest_roles"] = {k: list(v) for k, v in roles.items()}
    for name, req in mv_requests.items():
        # one warm-up: the path's run above staged and warmed every table
        ms, _ = cuda_ms(lambda: reduce_to_response(req, [mv_ex.execute(mv_segments, req)]), MV_ITERS, warmup=1)
        log(f"query {name}: {ms:.3f} ms median of {MV_ITERS}, {mv_rows / (ms / 1e3):.4g} rows/s")
        record["query_ms"][name] = ms
    if opts.profile:
        for name, req in mv_requests.items():
            record["profile"][name] = profile_query(
                lambda: reduce_to_response(req, [mv_ex.execute(mv_segments, req)]), name)

    # K1 and K2 at the MV launch shapes, each against its plain version
    # and its bound: the last launch of each kernel in each query
    record["k1_mv"], record["k2_mv"] = {}, {}
    for name, req in mv_requests.items():
        captured.clear()
        restore = (_capture(fg, "fused_filtered_groupby_sums", captured, "k1"), vsc.value_state)

        def by_mode(mode, *a, **k):
            captured[f"k2/{mode}"] = ((mode, *a), k)
            return restore[1](mode, *a, **k)

        vsc.value_state = by_mode
        try:
            mv_ex.execute(mv_segments, req)
        finally:
            fg.fused_filtered_groupby_sums, vsc.value_state = restore
        if "k1" in captured:
            a, k = captured.pop("k1")
            args = {**dict(zip(names, a)), **k}
            err, tiers = compare_k1(fg, args, AUDIT_RTOL, AUDIT_ATOL)
            k_ms, _ = cuda_ms(lambda: fg.fused_filtered_groupby_sums(**args), ITERS)
            # one run, after compare_k1's own call of the plain version
            p_ms, _ = cuda_ms(lambda: fg.fused_filtered_groupby_sums_reference(**args), 1, warmup=0)
            bound, bound_by, nbytes, ops = k1_bound(args)
            lead = args["group_keys"] if args["group_keys"] is not None else args["group_cols"][0]
            form = "group_keys (a key window)" if args["group_keys"] is not None else "group_cols"
            log(f"k1 {name} ({form}, [S, N] = {list(lead.shape)}, K={args['capacity']}, "
                f"nv={len(args['value_dicts'])}, tier {fg.choose_tier(*k1_shape(fg, args))}): {k_ms:.4f} ms "
                f"(bound {bound:.4f} ms by {bound_by}: {nbytes} bytes, {ops} operations; {bound / k_ms:.3f} of "
                f"the bound), plain {p_ms:.4f} ms, tiers checked {tiers}, max_abs_err {err:.6g}")
            record["k1_mv"][name] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=bound_by, bytes=nbytes,
                                         operations=ops, shape=list(lead.shape), capacity=args["capacity"],
                                         key_form=form, max_abs_err=err, tiers=tiers)
            del args, a, k
        for key in sorted(k for k in captured if k.startswith("k2/")):
            (mode, *rest), kw = captured.pop(key)
            args = {**dict(zip(("num_docs", "values"), rest)), **kw}
            tiers = compare_k2_value(vsc, mode, args)
            k_ms, _ = cuda_ms(lambda: vsc.value_state(mode, **args), ITERS)
            bound, bound_by, nbytes, ops = k2_bound(vsc, mode, args)
            # every row of the entry mask holds a valid entry, so no warp
            # skips a stream: a device time under the bound lost records
            dev_ms = sum(device_ms(lambda: vsc.value_state(mode, **args), floor_ms=bound).values())
            p_ms, _ = cuda_ms(lambda: vsc.value_state_reference(mode, **args), 1, warmup=0)
            K = vsc.index_space(mode, args["capacity"], args.get("width"))
            log(f"k2 {name}/{mode} ([S, N] = {list(args['values'].shape)}, K={K}): {k_ms:.4f} ms per call, "
                f"{dev_ms:.4f} ms on the device (bound {bound:.4f} ms by {bound_by}: {nbytes} bytes, {ops} "
                f"operations; per call {bound / k_ms:.3f} of it), plain {p_ms:.4f} ms, tiers checked {tiers}, "
                f"max_abs_err 0")
            record["k2_mv"][f"{name}/{mode}"] = dict(mode=mode, K=K, ms=k_ms, device_ms=dev_ms, plain_ms=p_ms, bound_ms=bound,
                                         bound_by=bound_by, bytes=nbytes, operations=ops,
                                         shape=list(args["values"].shape), tiers=tiers, max_abs_err=0.0)
            del args, rest, kw
        torch.cuda.empty_cache()

    log(f"elapsed {time.perf_counter() - t_start:.1f} s: phase 8 done")
    # 9. serving: the direct executors' tables are freed first, so the card
    # never holds two copies
    mv_ex.free_staging()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    serve_phase(dev, segments, wants, record, fg, vsc)
    log(f"serving phase: {time.perf_counter() - t0:.1f} s")

    # 10a. zone maps in process: zone_in through K1's fused route and
    # zone_distinct through K2's over the candidate zone blocks only (the
    # kernels read them in place), then the same queries as full scans
    # (zone_maps=False), each against its host oracle
    t0 = time.perf_counter()
    zone_requests = {k: parse(v) for k, v in ZONE_QUERIES.items()}
    wants["zone_in"] = pending["zone_in"].result()
    wants["zone_distinct"] = pending["zone_distinct"].result()
    # past the postings tier, which serves both three-date lists by default
    # (phase 13 and the deployed cluster); this phase holds the block path
    zex = QueryExecutor(device=dev, precision="x32", postings=False)
    zfull = QueryExecutor(device=dev, precision="x32", postings=False, zone_maps=False)
    zone_need = {"zone_in": ("k1",), "zone_distinct": ("k2",)}
    record["zone"] = {}
    for path, executor, blocks in (("zone_blocks", zex, 2), ("zone_full", zfull, 0)):
        b0 = kernel_mod.block_dispatches
        answers = drive(path, zone_requests, segments, zone_need, executor=executor)
        routes = (kernel_mod.fused_dispatches, kernel_mod.fused_value_dispatches,
                  kernel_mod.block_dispatches - b0)
        if routes != (1, 1, blocks):
            raise AssertionError(f"{path}: fused, fused value and block dispatches {routes}, not (1, 1, {blocks})")
        worst = check_response(answers["zone_in"], wants["zone_in"])
        check_value_response(answers["zone_distinct"], wants["zone_distinct"])
        log(f"oracle {path}: zone_in ok (max rel sum err {worst:.3g}), zone_distinct ok, exact "
            f"({answers['zone_distinct'].aggregation_results[0].value})")
    for name, req in zone_requests.items():
        on, off = zex.execute(segments, req), zfull.execute(segments, req)
        ms_on, _ = cuda_ms(lambda: reduce_to_response(req, [zex.execute(segments, req)]), QUERY_ITERS)
        ms_off, _ = cuda_ms(lambda: reduce_to_response(req, [zfull.execute(segments, req)]), QUERY_ITERS)
        z = record["zone"][name] = dict(blocks_ms=ms_on, full_ms=ms_off,
                                        scanned_rows=on.num_entries_scanned_in_filter,
                                        full_rows=off.num_entries_scanned_in_filter,
                                        segments_zonemap=on.cost.get("segmentsZonemap"))
        log(f"query {name}: {ms_on:.3f} ms median of {QUERY_ITERS} over the candidate blocks "
            f"({z['scanned_rows']} rows scanned in the filter, segmentsZonemap {z['segments_zonemap']}); "
            f"{ms_off:.3f} ms as a full scan ({z['full_rows']} rows)")
    decision_ms(zex, zone_requests, "the block path")

    # the switch on both sides: each sweep query over the blocks with the
    # switch forced open (its window: nb_pad over a segment's blocks), and
    # as a full scan; answers equal (counts and distinct counts exactly,
    # sums within the audit band), the host time of the decision
    # (candidate map and block table), and the query's K1 or K2 launch
    # timed alone on each path
    record["zone_sweep"] = {}
    skip_ms, window = [], {}

    def kernel_ms(executor, req, key: str) -> float:
        """Per-call ms of the query's K1 (``key`` "k1") or K2 launch, as
        ``executor`` hands it the inputs."""
        captured.clear()
        restore = (_capture(fg, "fused_filtered_groupby_sums", captured, "k1"),
                   _capture(vsc, "value_state", captured, "k2"))
        try:
            executor.execute(segments, req)
        finally:
            fg.fused_filtered_groupby_sums, vsc.value_state = restore
        if key == "k1":
            a, k = captured.pop("k1")
            args = {**dict(zip(names, a)), **k}
            return cuda_ms(lambda: fg.fused_filtered_groupby_sums(**args), ITERS)[0]
        (mode, *rest), kw = captured.pop("k2")
        args = {**dict(zip(("num_docs", "values"), rest)), **kw}
        return cuda_ms(lambda: vsc.value_state(mode, **args), ITERS)[0]

    real_skip = zex._block_skip_ids

    def timed_skip(plan, q_np, live, staged):
        t = time.perf_counter()
        rows = real_skip(plan, q_np, live, staged)
        skip_ms.append((time.perf_counter() - t) * 1e3)
        window["nb_pad"] = None if rows is None else q_np["block_ids"].shape[1]
        window["blocks"] = staged.n_pad // config.ZONE_BLOCK
        return rows

    zex._block_skip_ids = timed_skip
    fraction, config.ZONE_MAX_FRACTION = config.ZONE_MAX_FRACTION, 1.0
    try:
        for name, pql in zone_sweep_queries(segments[0]).items():
            req = parse(pql)
            b0 = kernel_mod.block_dispatches
            on, off = zex.execute(segments, req), zfull.execute(segments, req)
            if kernel_mod.block_dispatches != b0 + 1:
                raise AssertionError(f"zone sweep {name}: the block path did not engage")
            r_on, r_off = reduce_to_response(req, [on]), reduce_to_response(req, [off])
            if name.startswith("zone_in"):
                check_response(r_on, response_as_want(r_off))
            elif r_on.aggregation_results[0].value != r_off.aggregation_results[0].value:
                raise AssertionError(f"zone sweep {name}: {r_on.aggregation_results[0].value} over the "
                                     f"blocks != {r_off.aggregation_results[0].value} as a full scan")
            skip_ms.clear()
            ms_on, _ = cuda_ms(lambda: reduce_to_response(req, [zex.execute(segments, req)]), QUERY_ITERS)
            ms_off, _ = cuda_ms(lambda: reduce_to_response(req, [zfull.execute(segments, req)]), QUERY_ITERS)
            key = "k1" if name.startswith("zone_in") else "k2"
            z = record["zone_sweep"][name] = dict(
                blocks_ms=ms_on, full_ms=ms_off, window=window["nb_pad"] / window["blocks"],
                scanned_share=on.num_entries_scanned_in_filter / off.num_entries_scanned_in_filter,
                decision_ms=float(np.median(skip_ms)), kernel=key,
                kernel_blocks_ms=kernel_ms(zex, req, key), kernel_full_ms=kernel_ms(zfull, req, key))
            log(f"zone sweep {name}: window {window['nb_pad']} of {window['blocks']} blocks a segment "
                f"({z['window']:.4f}), candidate rows {z['scanned_share']:.4f} of the table; {ms_on:.3f} ms "
                f"median of {QUERY_ITERS} over the blocks (decision {z['decision_ms']:.4f} ms on the host), "
                f"{ms_off:.3f} ms as a full scan; {key} {z['kernel_blocks_ms']:.4f} ms per call over the "
                f"blocks, {z['kernel_full_ms']:.4f} ms as a full scan")
    finally:
        config.ZONE_MAX_FRACTION = fraction
        zex._block_skip_ids = real_skip

    # K1 and K2 at the block path's launch shapes and the full scan's
    record["k1_zone"], record["k2_zone"] = {}, {}
    for label, executor in (("blocks", zex), ("full", zfull)):
        captured.clear()
        restore = (_capture(fg, "fused_filtered_groupby_sums", captured, "k1"),
                   _capture(vsc, "value_state", captured, "k2"))
        try:
            executor.execute(segments, zone_requests["zone_in"])
            executor.execute(segments, zone_requests["zone_distinct"])
        finally:
            fg.fused_filtered_groupby_sums, vsc.value_state = restore
        a, k = captured["k1"]
        args = {**dict(zip(names, a)), **k}
        if (args.get("block_ids") is not None) != (label == "blocks"):
            raise AssertionError(f"k1 zone_in {label}: block table {args.get('block_ids') is not None}")
        err, tiers = compare_k1(fg, args, AUDIT_RTOL, AUDIT_ATOL)
        k_ms, _ = cuda_ms(lambda: fg.fused_filtered_groupby_sums(**args), ITERS)
        p_ms, _ = cuda_ms(lambda: fg.fused_filtered_groupby_sums_reference(**args), 1, warmup=0)
        rows = k1_bytes(args)[0]
        matched = int(fg.fused_filtered_groupby_sums(**args)[0])
        bound, bound_by, nbytes, ops = k1_bound(args, matched)
        all_rows = k1_bound(args)[0]
        shape = list(args["block_ids"].shape) + [args["block_rows"]] if label == "blocks" else \
            list(args["group_cols"][0].shape)
        log(f"k1 zone_in {label} ({'[S, nb_pad, block]' if label == 'blocks' else '[S, n_pad]'} = {shape}, "
            f"{rows} rows read, {matched} matched, tier {fg.choose_tier(*k1_shape(fg, args))}): {k_ms:.4f} ms "
            f"(bound {bound:.4f} ms by {bound_by}: {nbytes} bytes, {ops} operations; {bound / k_ms:.3f} of the "
            f"bound; {all_rows:.4f} ms charging every stream of every row read), plain {p_ms:.4f} ms, "
            f"tiers checked {tiers}, max_abs_err {err:.6g}")
        record["k1_zone"][label] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=bound_by, bytes=nbytes,
                                        operations=ops, rows=rows, matched=matched, all_rows_bound_ms=all_rows,
                                        shape=shape, max_abs_err=err, tiers=tiers)
        (mode, *rest), kw = captured["k2"]
        args = {**dict(zip(("num_docs", "values"), rest)), **kw}
        tiers = compare_k2_value(vsc, mode, args)
        k_ms, _ = cuda_ms(lambda: vsc.value_state(mode, **args), ITERS)
        dev_ms = sum(device_ms(lambda: vsc.value_state(mode, **args)).values())
        p_ms, _ = cuda_ms(lambda: vsc.value_state_reference(mode, **args), 1, warmup=0)
        rows = k2_bytes(vsc, mode, args)[0]
        matched = int(vsc.value_state(mode, **args)[0])
        bound, bound_by, nbytes, ops = k2_bound(vsc, mode, args, matched)
        all_rows = k2_bound(vsc, mode, args)[0]
        idx, K, _ = vsc.combine_index(mode, **args)
        lib_ms, _ = cuda_ms(lambda: torch.bincount(idx.reshape(-1), minlength=K + 1)[:K], ITERS)
        del idx
        shape = list(args["block_ids"].shape) + [args["block_rows"]] if label == "blocks" else \
            list(args["values"].shape)
        log(f"k2 zone_distinct {label} ({mode}, K={K}, shape {shape}, {rows} rows read, {matched} matched): "
            f"{k_ms:.4f} ms per call, {dev_ms:.4f} ms on the device (bound {bound:.4f} ms by {bound_by}: {nbytes} "
            f"bytes, {ops} operations; per call {bound / k_ms:.3f} of it; {all_rows:.4f} ms charging every stream "
            f"of every row read), plain {p_ms:.4f} ms, torch.bincount over the combined index "
            f"{lib_ms:.4f} ms, tiers checked {tiers}, max_abs_err 0")
        record["k2_zone"][label] = dict(mode=mode, K=K, ms=k_ms, device_ms=dev_ms, plain_ms=p_ms, bound_ms=bound,
                                        bound_by=bound_by, bytes=nbytes, operations=ops, rows=rows, matched=matched,
                                        all_rows_bound_ms=all_rows, shape=shape, library_ms=lib_ms, tiers=tiers,
                                        max_abs_err=0.0)
        del args
    zex.free_staging()
    zfull.free_staging()
    del zex, zfull
    torch.cuda.empty_cache()
    log(f"zone phase: {time.perf_counter() - t0:.1f} s")

    # 10b. the deployed cluster, each role its own process
    # and 11c. the deployed joins on its roles, before they stop
    t0 = time.perf_counter()
    ssb, join_wants = join_data()
    deployed_phase(segments, wants, record,
                   then=lambda roles: deployed_join_phase(ssb, join_wants, record, roles))
    log(f"deployed phase (the deployed joins included): {time.perf_counter() - t0:.1f} s")

    # 11. joins: SSB lineorder / part / date in process, through two servers
    # and the broker over TCP (their deployed step ran on phase 10's roles)
    t0 = time.perf_counter()
    join_phase(dev, ssb, join_wants, record, fg, vsc)
    log(f"joins phase: {time.perf_counter() - t0:.1f} s")

    # 12. star-tree tables: baseball_cube and adevents_hll_cube (phase 4's
    # ad-events segments), from the cube and from K1 / K2
    t0 = time.perf_counter()
    ex.free_staging()
    torch.cuda.empty_cache()
    startree_phase(dev, record, fg, vsc, ad_distinct=ad_distinct, ns_want=ns_want)
    log(f"startree phase: {time.perf_counter() - t0:.1f} s")

    # 13. the postings and bit-sliced tiers over phase 1's lineitem
    t0 = time.perf_counter()
    tiers_phase(dev, segments, record, fg, vsc, drive)
    log(f"tiers phase: {time.perf_counter() - t0:.1f} s")

    # 14. realtime ingestion: lineitem as a REALTIME table, consumed by two
    # server processes from the stream broker, queried at its watermarks
    t0 = time.perf_counter()
    ex.free_staging()
    torch.cuda.empty_cache()
    realtime_phase(dev, record, fg, vsc, hll_mod)
    log(f"realtime phase: {time.perf_counter() - t0:.1f} s")

    # 15. residency: one server's staging under an HBM cap, the cold spool,
    # a real OOM healed by demotion, EXPLAIN over the tiers
    t0 = time.perf_counter()
    residency_phase(dev, segments, record, fg, vsc, wants)
    log(f"residency phase: {time.perf_counter() - t0:.1f} s")

    # 16. the offline build path and schema evolution: CSV and Avro files
    # built by BatchCreateSegments (a local pool, remote workers), pushed to
    # a deployed cluster, the schema grown under it; K1 / K2 at the evolved
    # shapes in process over copies of phase 1's segments
    t0 = time.perf_counter()
    ex.free_staging()
    torch.cuda.empty_cache()
    build_phase(dev, segments, record, fg, vsc, hll_mod)
    log(f"build phase: {time.perf_counter() - t0:.1f} s")
    log(f"elapsed {time.perf_counter() - t_start:.1f} s: phases 1-16 done")

    # 17. the warm start and the utilization planes: a deployed cluster
    # with the compile cache on, the planes read across the roles, a
    # profiler capture, one server restarted three times
    t0 = time.perf_counter()
    ex.free_staging()
    torch.cuda.empty_cache()
    warmstart_phase(dev, segments[:WARM_SEGMENTS], {n: f.result() for n, f in warm_pending.items()}, record,
                    warm_roots, fg, vsc)
    log(f"warm start phase: {time.perf_counter() - t0:.1f} s")
    log(f"elapsed {time.perf_counter() - t_start:.1f} s: phases 17 and 19 done (19 {record['controller']['wall_s']:.1f} s "
        f"inside 17)")
    pl = record["planes"]
    log(f"elapsed {time.perf_counter() - t_start:.1f} s: phase 18 done ((a) {pl['wall_s']:.1f} s inside phase 9, "
        f"(b) inside phase 14, (c) {pl['deployed']['wall_s']:.1f} s inside phase 17)")

    # 20. Kafka and HLC ingestion: lineitem rows as JSON messages through the
    # Kafka wire protocol and the consumer groups, the hybrid quickstart
    t0 = time.perf_counter()
    ex.free_staging()
    torch.cuda.empty_cache()
    kafka_phase(dev, record, fg, vsc, hll_mod)
    log(f"kafka phase: {time.perf_counter() - t0:.1f} s")

    # 21. the link fault plane: a networked cluster in this process, every
    # link through one seeded injector, the partition scenarios and
    # disaster recovery under closed-loop q1 / distinct_price
    t0 = time.perf_counter()
    netfaults_phase(dev, record, fg, vsc, hll_mod)
    log(f"netfaults phase: {time.perf_counter() - t0:.1f} s")

    # the routes line: the tier the default executor serves each query of
    # phases 1-13 from (the mvtest queries decided on one distinct segment:
    # the shares are the same, and its postings are built once, then freed)
    from pinot_tpu_torch.segment.invindex import release_postings

    t0 = time.perf_counter()
    lineitem_pqls = {**QUERIES, **VALUE_QUERIES, "torch_op": TORCH_OP_QUERY, **SELECTION_QUERIES,
                     **{k: PAIR_QUERIES[k] for k in ("pairs_pct", "pairs_distinct")},
                     "host_groups": HOST_QUERIES["host_groups"], **ZONE_QUERIES, **BSI_QUERIES,
                     **{f"q1_at/{d_}": q1_at(d_) for d_ in BATCH_DATES},
                     **{f"range_at/{t_}": range_at(t_) for t_ in QTY_LADDER},
                     **{f"distinct_at/{t_}": distinct_at(t_) for t_ in QTY_LADDER},
                     **{f"hll_at/{m_}": hll_at(m_) for m_ in SHIP_MODES}}
    record_routes(record, "lineitem", lineitem_pqls, segments, parse)
    record_routes(record, "adevents", {k: PAIR_QUERIES[k] for k in ("reach_exact", "reach_hll_site")}
                  | {"north_star": NORTH_STAR, "reach_overflow": HOST_QUERIES["reach_overflow"]}, ad_segments, parse)
    record_routes(record, "mvtest", {k: v.format(**values) for k, v in MV_QUERIES.items()}, mv_distinct[:1], parse)
    release_postings(mv_distinct[0])
    routes = {k: v[0] for k, v in record["routes"].items()}
    log(f"routes ({time.perf_counter() - t0:.1f} s; the joins take the join phase, neither tier): "
        f"{json.dumps(routes)}")

    launches = {"k1": 0, "k2": 0}
    for path in record["paths"].values():
        for kern in launches:
            launches[kern] += path["totals"][kern]
    q1, hg = record["k1"]["q1"], record["k2"]["hll_groupby"]
    zk1, zk2 = record["k1_zone"], record["k2_zone"]

    def block_path(query: str, z: dict) -> dict:
        b, f = z["blocks"], z["full"]
        return {"query": query, "shape_S_nb_pad_block": b["shape"], "rows": b["rows"], "matched": b["matched"],
                "ms": b["ms"],
                "plain_ms": b["plain_ms"], "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                "full_scan_ms": f["ms"], "full_scan_bound_ms": f["bound_ms"],
                "launches": record["paths"]["zone_blocks"]["launches"][query]}

    def batched_entry(name: str, base: dict, ladder: str, counter: str) -> dict:
        """The kernels line's entry of a batched wrapper: its q1 / distinct
        ladder at BATCH_LINE members, the bursts' launches, every B."""
        probe = record["batched"][ladder]
        at = probe["by_B"][BATCH_LINE]
        return {"name": name, "route": "cuda", "source": base["source"], "replaces": base["replaces"],
                "launches": record["batched_paths"]["serving"]["totals"][counter],
                "max_abs_err": probe["max_abs_err"], "ms": at["ms"], "plain_ms": at["plain_ms"],
                "bound_ms": at["bound_ms"], "bound_by": at["bound_by"], "library_ms": at.get("library_ms"),
                "ladder": ladder, "members": BATCH_LINE, "one_member_ms": probe["one_member_ms"],
                "by_B": {lab: {B: {k: r[k] for k in ("ms", "per_member_ms", "solo_total_ms", "bound_ms")}
                               for B, r in record["batched"][lab]["by_B"].items()}
                         for lab in record["batched"] if record["batched"][lab]["kind"] == probe["kind"]}}

    summary = {"kernels": [
        {
            "name": "fused_filtered_groupby_sums",
            "route": "cuda",
            "source": "pinot_tpu_torch/csrc/fused_groupby.cu",
            "replaces": "pinot_tpu/engine/pallas_kernels.py:95",
            "launches": launches["k1"],
            "max_abs_err": q1["max_abs_err"],
            "ms": q1["ms"],
            "plain_ms": q1["plain_ms"],
            "bound_ms": q1["bound_ms"],
            "bound_by": q1["bound_by"],
            "library_ms": None,
            "block_path": block_path("zone_in", zk1),
            "join_shape": {name: dict(record["joins"]["stages"][name]["k1"],
                                      launches=record["paths"]["joins"]["launches"][name]["k1"])
                           for name in JOIN_QUERIES if "k1" in record["joins"]["stages"][name]},
            "startree_shape": record["startree"]["k1"],
            "tiers_shape": record["tiers"]["k1"],
            "realtime_shape": record["realtime"]["k1"],
            "kafka_shape": dict(record["kafka"]["k1"], launches=record["paths"]["kafka"]["totals"]["k1"]),
            "hlc_shape": record["kafka"]["hlc_k1"],
            "netfaults_shape": dict(record["netfaults"]["k1"],
                                    launches=record["paths"]["netfaults"]["totals"]["k1"]),
            "build_shape": record["build"]["k1"],
            "warmstart_launches": record["paths"]["warmstart"]["totals"]["k1"],
            "planes_launches": record["paths"]["planes"]["totals"]["k1"],
            "controller_launches": record["paths"]["controller"]["totals"]["k1"],
        },
        {
            "name": "value_state_counts",
            "route": "cuda",
            "source": "pinot_tpu_torch/csrc/value_state_counts.cu",
            "replaces": "pinot_tpu/engine/kernel.py:130",
            "launches": launches["k2"],
            "max_abs_err": hg["max_abs_err"],
            "ms": hg["ms"],
            "plain_ms": hg["plain_ms"],
            "bound_ms": hg["bound_ms"],
            "bound_by": hg["bound_by"],
            "library_ms": hg["library_ms"],
            "block_path": dict(block_path("zone_distinct", zk2), library_ms=zk2["blocks"]["library_ms"]),
            "realtime_shape": record["realtime"]["k2"],
            "kafka_shape": dict(record["kafka"]["k2"], launches=record["paths"]["kafka"]["totals"]["k2"]),
            "hlc_shape": record["kafka"]["hlc_k2"],
            "netfaults_shape": dict(record["netfaults"]["k2"],
                                    launches=record["paths"]["netfaults"]["totals"]["k2"]),
            "build_shape": record["build"]["k2"],
            "warmstart_launches": record["paths"]["warmstart"]["totals"]["k2"],
            "planes_launches": record["paths"]["planes"]["totals"]["k2"],
            "controller_launches": record["paths"]["controller"]["totals"]["k2"],
        },
    ]}
    summary["kernels"] += [
        batched_entry("fused_filtered_groupby_sums_batched", summary["kernels"][0], "q1_dates", "k1_batched"),
        batched_entry("value_state_batched", summary["kernels"][1], "distinct_price_qty", "k2_batched"),
    ]
    tr = record["tiers"]
    summary["tiers"] = {
        "postings_build_s_per_segment": float(np.median(tr["postings_build"]["s_per_segment"])),
        "postings_bytes": {c: v["bytes"] for c, v in tr["postings_build"]["by_column"].items()},
        "crossover": {k: {f: v.get(f) for f in ("where", "crossover_share", "below_share", "above_share")}
                      for k, v in tr["crossover"].items()},
        "bitsliced": {n: {k: r[k] for k in ("program_ms", "packed_call_ms", "bound_ms", "query_ms", "scan_query_ms",
                                            "planes")} for n, r in tr["bitsliced"].items()},
        "batched_ms": {B: r["ms"] for B, r in tr["batched"].items()},
        "batched_member_over_one_solo": {B: r["member_over_one_solo"] for B, r in tr["batched"].items()},
        "routes": {t: sum(1 for v in routes.values() if v == t) for t in sorted(set(routes.values()))},
    }
    record["summary"] = summary
    record["wall_s"] = time.perf_counter() - t_start
    log(f"wall: {record['wall_s']:.1f} s")
    if opts.out:
        record["log_times"] = LOG_TIMES
        with open(opts.out, "w") as f:
            json.dump(record, f, indent=1)
    log(json.dumps(summary))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
