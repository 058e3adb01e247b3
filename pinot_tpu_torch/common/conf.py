"""Per-process configuration (copy of ``pinot_tpu.common.conf``).

The reference layers its config: per-process ``.properties`` files
(``ServerConf.java``, ``ControllerConf.java:28``,
``DefaultHelixBrokerConfig``) with keys centralized in
``CommonConstants.java:26``.  Here: typed dataclasses with the same key
namespace, loadable from java-properties-style text or dicts.  The
broker's retry, hedge, circuit-breaker and admission knobs reach
``BrokerRequestHandler.from_conf``; ``env_float`` and ``env_int`` are
the readers of a numeric knob from the environment (admission, the
ingest governor, the auditors, the result cache, the tail sampler, the
flight recorder, the SLO tracker)."""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any, Dict, Type, TypeVar

T = TypeVar("T", bound="BaseConf")


def env_float(name: str, default: float = 0.0) -> float:
    """Float from the environment, falling back on absent OR junk
    values (a malformed knob must degrade to the default, not crash
    the role at construction)."""
    import os

    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def env_int(name: str, default: int = 0) -> int:
    """Integer from the environment, with ``env_float``'s fallback."""
    import os

    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def parse_properties(text: str) -> Dict[str, str]:
    """Parse java-properties-style ``key=value`` lines (# comments)."""
    out: Dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, _, value = line.partition("=")
        out[key.strip()] = value.strip()
    return out


class BaseConf:
    PREFIX = ""

    @classmethod
    def from_dict(cls: Type[T], props: Dict[str, Any]) -> T:
        kwargs: Dict[str, Any] = {}
        for f in fields(cls):  # type: ignore[arg-type]
            key = f"{cls.PREFIX}{f.name.replace('_', '.')}"
            if key in props:
                raw = props[key]
                if f.type in ("int", int):
                    kwargs[f.name] = int(raw)
                elif f.type in ("float", float):
                    kwargs[f.name] = float(raw)
                elif f.type in ("bool", bool):
                    kwargs[f.name] = str(raw).lower() in ("1", "true", "yes")
                else:
                    kwargs[f.name] = raw
        return cls(**kwargs)  # type: ignore[call-arg]

    @classmethod
    def from_properties_file(cls: Type[T], path: str) -> T:
        with open(path) as f:
            return cls.from_dict(parse_properties(f.read()))


@dataclass
class ServerConf(BaseConf):
    """pinot.server.* (ServerConf.java keys)."""

    PREFIX = "pinot.server."

    instance_id: str = "server0"
    netty_port: int = 8098
    query_executor_timeout_ms: int = 15_000  # ServerQueryExecutorV1Impl.java:58
    query_worker_threads: int = 4
    instance_data_dir: str = "/tmp/pinot_tpu/server/index"
    instance_segment_tar_dir: str = "/tmp/pinot_tpu/server/tar"


@dataclass
class BrokerConf(BaseConf):
    """pinot.broker.* (DefaultHelixBrokerConfig keys)."""

    PREFIX = "pinot.broker."

    instance_id: str = "broker0"
    client_query_port: int = 8099
    timeout_ms: int = 15_000
    routing_table_count: int = 10
    max_query_qps: float = 0.0  # 0 = unlimited (QuotaConfig enforcement)
    # -- resilience knobs (scatter-gather retry / hedge / circuit breaker)
    retry_attempts: int = 2  # failover re-issues per segment set beyond the first send
    retry_backoff_ms: float = 25.0  # capped exponential base between re-issues
    retry_backoff_cap_ms: float = 1_000.0
    hedge_delay_ms: float = 0.0  # 0 disables hedged requests
    hedge_latency_percentile: float = 95.0  # observed-latency percentile that arms a hedge
    hedge_min_quota_headroom: float = 0.1  # skip hedging when the table is near its QPS quota
    health_failure_threshold: int = 3  # consecutive failures before the penalty box
    health_penalty_ms: float = 5_000.0  # circuit-open duration before a half-open probe
    # -- adaptive admission (broker/admission.py overload front door)
    admission_table_inflight: int = 32  # per-table in-flight concurrency cap
    admission_window_init: float = 8.0  # AIMD per-server window start
    admission_window_max: float = 64.0  # AIMD window additive-increase ceiling
    admission_pending_high_water: float = 0.8  # backpressure saturation fraction


@dataclass
class ControllerConf(BaseConf):
    """controller.* (ControllerConf.java:28 keys)."""

    PREFIX = "controller."

    host: str = "127.0.0.1"
    port: int = 9000
    data_dir: str = "/tmp/pinot_tpu/controller/data"
    retention_frequency_seconds: int = 3600
    validation_frequency_seconds: int = 300
    status_check_frequency_seconds: int = 300
