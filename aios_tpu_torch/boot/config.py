"""Layered TOML configuration.

Reference parity (initd/src/config.rs:14-34 + config/default-config.toml):
the 9-section schema — system / boot / models / api / memory / security /
networking / agents / monitoring — loaded from /etc/aios/config.toml with
full defaults when the file is absent, plus env-var overrides for service
addresses (handled in aios_tpu_torch.services) and model/runtime knobs.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from .._compat import tomllib
from pathlib import Path
from typing import Any, Dict, List

DEFAULT_CONFIG_PATH = "/etc/aios/config.toml"


def _default_sections() -> Dict[str, Dict[str, Any]]:
    return {
        "system": {
            "hostname": "aios-tpu",
            "log_level": "info",
            "data_dir": "/tmp/aios",
        },
        "boot": {
            "health_timeout_seconds": 60,
            "max_restart_attempts": 5,
            "restart_window_seconds": 300,
            "emergency_shell": False,
        },
        "models": {
            "model_dir": "/var/lib/aios/models",
            "default_context": 4096,
            "num_slots": 8,
            "warm_compile": True,
            "autoload": True,
            # TPU serving knobs -> AIOS_TPU_* env for the runtime child
            # (serving_env(); docs/CONFIG.md documents each)
            "quantize": "",          # "" = auto; "0"/"1"/"int8"/"int4"
            "kv_cache": "",          # "int8" halves KV footprint/traffic
            # paged KV pool + prompt-prefix cache: "auto" sizes the pool
            # from the model's slots x context (dense-cache HBM + one
            # slot of slack) — the production default, so the 8 agents'
            # shared preambles hit the prefix index instead of re-
            # prefilling (BASELINE.md <200 ms agent-response target).
            # An integer sets a fixed row budget; 0 = dense slot cache.
            "paged_kv_rows": "auto",
            # host-RAM spill tier behind the prefix cache: evicted prefix
            # pages' KV is kept in host memory inside this byte budget
            # and restored device-side on a later hash-chain hit instead
            # of re-prefilled ("" / 0 = off; docs/CONFIG.md). The restore
            # floor skips the tier for chains shorter than N pages.
            "prefix_host_bytes": "",
            "host_restore_min_pages": "",
            # long-context tier (docs/ENGINE_PERF.md): window+sink KV
            # compression — past kv_compress_after rows a slot's paged KV
            # prunes to kv_sink_pages leading + kv_window_pages trailing
            # pages ("" / 0 = off, exact full attention); prompts >=
            # seq_prefill_min rows prefill in one dispatch sharded over
            # the mesh's sp axis ("" / 0 = off; needs sp > 1 in mesh).
            "kv_compress_after": "",
            "kv_sink_pages": "",
            "kv_window_pages": "",
            "seq_prefill_min": "",
            "speculative": False,    # n-gram speculative decode
            # draft-model speculation: pair each managed model with a
            # small draft (preset name or weights path, e.g. "tinyllama")
            # served int4 — the serving model verifies its proposals in
            # one dispatch (docs/ENGINE_PERF.md). "" = n-gram only.
            # spec_reprobe_secs: how long an auto-disabled proposer stays
            # suspended before probe dispatches re-measure ("" = 10 s).
            "draft_model": "",
            "spec_reprobe_secs": "",
            # pipelined decode loop: dispatch N+1 enqueues while dispatch
            # N's tokens are emitted/detokenized (docs/ENGINE_PERF.md);
            # unified_step folds every decode chunk size into ONE
            # dynamic-n XLA graph (greedy-identical; opt-in). "" = off.
            "decode_pipeline": "",
            "unified_step": "",
            # device-resident multi-tick decode megagraph: up to this
            # many decode ticks per dispatch with on-device sampling,
            # stop detection and budget/cap checks (early exit when no
            # slot needs another tick; docs/ENGINE_PERF.md). "" = off.
            "mega_ticks": "",
            # grammar jump-ahead for constrained/structured decoding
            # (multi-token forced runs in one dispatch; default ON) and
            # the radix-tree prefix index (default ON) — tri-state
            # escape hatches; spec_min_accept floors the speculative
            # EWMA acceptance ratio (0/"" = never auto-disable).
            "jump_ahead": "",
            "prefix_radix": "",
            "spec_min_accept": "",
            "json_mode": "",         # "force" = reference json_object parity
            "guided_toolcalls": False,  # schema-guided reasoning replies
            # multi-chip serving mesh, e.g. "tp=4" (BASELINE config 4:
            # Mistral-7B TP over a v5e-4) or "dp=2,sp=2,tp=2"; "" = one
            # chip. With sp > 1, models whose KV cache exceeds the
            # per-chip HBM budget automatically shard their context axis
            # over sp (the long-context degradation path — paging is
            # dropped for those models since pages cannot split across
            # sp shards).
            "mesh": "",
            # serving layer (docs/SERVING.md): replicas per managed model
            # behind the cache-aware router; per-tenant token-bucket
            # quota (tokens/sec + burst, 0 = off); bounded admission
            # queue per replica (an EXPLICIT max_queue = 0 means
            # unbounded, same as the env knob); deadline-feasibility
            # rate floor. "" = unset (serving defaults apply).
            "replicas": "",
            "tenant_tokens_per_sec": "",
            "tenant_burst_tokens": "",
            "max_queue": "",
            "assumed_tps": "",
        },
        "api": {
            "claude_model": "claude-sonnet-4-20250514",
            "openai_model": "gpt-5",
            "qwen3_model": "qwen3:30b-128k",
            "claude_monthly_budget": 100.0,
            "openai_monthly_budget": 50.0,
        },
        "memory": {
            "operational_capacity": 10000,
            "working_retention_days": 30,
            "longterm_retention_days": 365,
            "migration_interval_seconds": 300,
        },
        "security": {
            "audit_db": "/tmp/aios/ledger/audit.db",
            "cert_dir": "/tmp/aios/certs",
            "secrets_path": "/etc/aios/secrets.toml",
            "sandbox_memory_mb": 256,
        },
        "networking": {
            "bind_host": "127.0.0.1",
            "console_port": 9090,
            "cluster_enabled": False,
        },
        "agents": {
            "config_dir": "/etc/aios/agents",
            "default_agents": ["system", "network", "security"],
            "max_restart_attempts": 5,
            "heartbeat_seconds": 10,
            "poll_seconds": 2,
        },
        "monitoring": {
            "proactive_interval_seconds": 60,
            "cpu_threshold": 90.0,
            "memory_threshold": 85.0,
            "disk_threshold": 90.0,
        },
    }


@dataclass
class AiosConfig:
    sections: Dict[str, Dict[str, Any]] = field(default_factory=_default_sections)
    source_path: str = ""

    def get(self, section: str, key: str, default: Any = None) -> Any:
        return self.sections.get(section, {}).get(key, default)

    def section(self, name: str) -> Dict[str, Any]:
        return dict(self.sections.get(name, {}))

    @property
    def data_dir(self) -> str:
        return os.environ.get("AIOS_DATA_DIR") or self.get(
            "system", "data_dir", "/tmp/aios"
        )


def load_config(path: str | None = None) -> AiosConfig:
    """Defaults deep-merged with the TOML file when present."""
    path = path or os.environ.get("AIOS_CONFIG", DEFAULT_CONFIG_PATH)
    sections = _default_sections()
    source = ""
    p = Path(path)
    if p.is_file():
        try:
            loaded = tomllib.loads(p.read_text())
            for name, values in loaded.items():
                if isinstance(values, dict):
                    sections.setdefault(name, {}).update(values)
                else:
                    sections.setdefault("system", {})[name] = values
            source = str(p)
        except (OSError, ValueError):
            pass
    return AiosConfig(sections=sections, source_path=source)


def serving_env(cfg: "AiosConfig") -> Dict[str, str]:
    """Translate [models] serving knobs into the AIOS_TPU_* env the
    runtime/gateway/orchestrator children read (docs/CONFIG.md) — the
    boot-config analog of the reference's config.toml -> llama-server
    flag plumbing (initd/src/config.rs:14-34).

    Env beats config (the convention everywhere in this codebase): a knob
    the operator already exported is NOT injected, so config supplies
    defaults without clobbering an explicit override. A malformed value
    warns and is skipped — one bad tuning knob must not take down boot
    (the lenient pattern of model_manager's env parsers).
    """
    import logging

    log = logging.getLogger("aios.boot.config")
    m = cfg.section("models")
    env: Dict[str, str] = {}

    def put(key: str, value: str) -> None:
        if key in os.environ:
            log.info("%s already set in env; config value ignored", key)
        else:
            env[key] = value

    if str(m.get("quantize", "")) != "":
        put("AIOS_TPU_QUANTIZE", str(m["quantize"]))
    if m.get("kv_cache"):
        put("AIOS_TPU_KV_CACHE", str(m["kv_cache"]))
    paged = m.get("paged_kv_rows", "auto")
    if str(paged).strip().lower() == "auto":
        put("AIOS_TPU_PAGED_KV", "auto")
    else:
        try:
            rows = int(paged or 0)
        except (TypeError, ValueError):
            log.warning(
                "[models] paged_kv_rows=%r is not an integer or 'auto'; "
                "ignored", paged,
            )
            rows = 0
        if rows > 0:
            put("AIOS_TPU_PAGED_KV", str(rows))
    if m.get("mesh"):
        put("AIOS_TPU_MESH", str(m["mesh"]))
    if m.get("speculative"):
        put("AIOS_TPU_SPECULATIVE", "1")
    if m.get("draft_model"):
        put("AIOS_TPU_DRAFT_MODEL", str(m["draft_model"]))
    # tri-state decode-loop knobs: "" = unset (config/engine defaults
    # apply); an explicit false forwards too, so config can turn OFF a
    # ModelConfig.decode_pipeline/unified_step default
    for cfg_key, env_key in (
        ("decode_pipeline", "AIOS_TPU_DECODE_PIPELINE"),
        ("unified_step", "AIOS_TPU_UNIFIED_STEP"),
        ("jump_ahead", "AIOS_TPU_JUMP_AHEAD"),
        ("prefix_radix", "AIOS_TPU_PREFIX_RADIX"),
    ):
        raw = m.get(cfg_key, "")
        if raw in ("", None):
            continue
        truthy = str(raw).strip().lower() in ("1", "true", "on", "yes")
        put(env_key, "1" if truthy else "0")
    if m.get("json_mode"):
        put("AIOS_TPU_JSON_MODE", str(m["json_mode"]))
    if m.get("guided_toolcalls"):
        put("AIOS_TPU_GUIDED_TOOLCALLS", "1")
    # SLO autoscaling closed loop (docs/RUNBOOK.md §8): [models]
    # autoscale = true attaches the burn controller to every pool
    if m.get("autoscale"):
        put("AIOS_TPU_AUTOSCALE", "1")
    # serving-layer knobs (docs/SERVING.md): numeric; "" = unset (the
    # serving defaults apply). max_queue forwards an EXPLICIT 0 too —
    # it means unbounded, not "use the default bound".
    for cfg_key, env_key, zero_ok in (
        # prefix_host_bytes forwards an EXPLICIT 0 too — it means "host
        # tier off", overriding a ModelConfig.prefix_host_bytes default
        ("prefix_host_bytes", "AIOS_TPU_PREFIX_HOST_BYTES", True),
        ("host_restore_min_pages", "AIOS_TPU_HOST_RESTORE_MIN_PAGES", False),
        ("replicas", "AIOS_TPU_REPLICAS", False),
        ("tenant_tokens_per_sec", "AIOS_TPU_TENANT_TOKENS_PER_SEC", False),
        ("tenant_burst_tokens", "AIOS_TPU_TENANT_BURST_TOKENS", False),
        ("max_queue", "AIOS_TPU_MAX_QUEUE", True),
        ("assumed_tps", "AIOS_TPU_ASSUMED_TPS", False),
        # an explicit 0 forwards (it means "never auto-disable",
        # overriding a ModelConfig.spec_min_accept default)
        ("spec_min_accept", "AIOS_TPU_SPEC_MIN_ACCEPT", True),
        ("spec_reprobe_secs", "AIOS_TPU_SPEC_REPROBE_SECS", False),
        # failover_retries = 0 forwards (failover OFF, overriding the
        # serving default of 2)
        ("failover_retries", "AIOS_TPU_FAILOVER_RETRIES", True),
        ("failover_backoff_ms", "AIOS_TPU_FAILOVER_BACKOFF_MS", False),
        # long-context tier: an explicit kv_compress_after / seq_prefill
        # 0 forwards (compression / sp-sharded prefill OFF, overriding a
        # ModelConfig default)
        ("kv_compress_after", "AIOS_TPU_KV_COMPRESS_AFTER", True),
        ("kv_sink_pages", "AIOS_TPU_KV_SINK_PAGES", False),
        ("kv_window_pages", "AIOS_TPU_KV_WINDOW_PAGES", False),
        ("seq_prefill_min", "AIOS_TPU_SEQ_PREFILL_MIN", True),
        # an explicit 0 forwards (megagraph OFF, overriding a
        # ModelConfig.mega_ticks default)
        ("mega_ticks", "AIOS_TPU_MEGA_TICKS", True),
        # SLO autoscaler policy (serving/autoscale.py; only meaningful
        # with autoscale = true above)
        ("autoscale_max_replicas", "AIOS_TPU_AUTOSCALE_MAX_REPLICAS",
         False),
        ("autoscale_interval_secs", "AIOS_TPU_AUTOSCALE_INTERVAL_SECS",
         False),
        ("autoscale_up_burn", "AIOS_TPU_AUTOSCALE_UP_BURN", False),
        ("autoscale_down_burn", "AIOS_TPU_AUTOSCALE_DOWN_BURN", False),
        ("autoscale_hold_ticks", "AIOS_TPU_AUTOSCALE_HOLD_TICKS", False),
        # an explicit 0 forwards (cooldown OFF — hold ticks remain the
        # only damping)
        ("autoscale_cooldown_secs", "AIOS_TPU_AUTOSCALE_COOLDOWN_SECS",
         True),
    ):
        raw = m.get(cfg_key, "")
        if raw in ("", None):
            continue
        try:
            value = float(raw)
        except (TypeError, ValueError):
            log.warning("[models] %s=%r is not a number; ignored",
                        cfg_key, raw)
            continue
        if value > 0 or (value == 0 and zero_ok):
            put(env_key, str(int(value) if value == int(value) else value))
    # [faults]: deterministic fault injection (docs/FAULTS.md). The
    # schedule string IS the AIOS_TPU_FAULTS grammar; a separate `seed`
    # key prepends for convenience. Deliberately env-beats-config like
    # everything else — an operator running a live chaos drill via env
    # wins over a config left armed.
    f = cfg.section("faults")
    schedule = str(f.get("schedule", "") or "").strip()
    if schedule:
        seed = f.get("seed", "")
        if str(seed).strip() and "seed=" not in schedule:
            schedule = f"seed={seed};{schedule}"
        put("AIOS_TPU_FAULTS", schedule)
    return env
