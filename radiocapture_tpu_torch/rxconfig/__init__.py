"""Deployment configuration schema.

The reference configures deployments with a ``class rc_config`` defined
per site in ``configs/config_*.py`` and symlinked to ``config.py``
(reference README.md:83-85; schema fields per
configs/config_denver_prod_den940radio1.py:7-116,
config_denver_dev_den817.py:21-23, config_sdr100_usrp.py:9-10). This
module keeps the same vocabulary as typed dataclasses; deployment files
are plain Python that builds an ``RcConfig`` (config-is-code, like the
reference's trailing ``del self.systems[n]`` pattern).
"""

from __future__ import annotations

import uuid as _uuid
from dataclasses import dataclass, field


@dataclass
class SourceConfig:
    """One wideband IQ source (reference ``sources{}`` entries:
    type/args/gains/center_freq/samp_rate/offset,
    rc_frontend/receiver.py:88-204)."""
    type: str = "file"            # usrp | usrp2x | bladerf | rtlsdr | file | synthetic
    center_freq: float = 0.0      # Hz
    samp_rate: float = 2.4e6      # S/s
    offset: float = 0.0           # per-dongle ppm/Hz correction
    args: str = ""                # driver args (device serial, file path)
    gains: dict = field(default_factory=dict)   # e.g. {"RF": 14, "IF": 24}
    frequency: float | None = None  # alias some reference configs use

    def __post_init__(self):
        if self.frequency is not None and not self.center_freq:
            self.center_freq = self.frequency


@dataclass
class SystemConfig:
    """One trunked system (reference ``systems{}`` entries)."""
    type: str                     # p25 | edacs | moto
    id: str = ""                  # human-readable system name
    channels: dict = field(default_factory=dict)   # {lcn: freq_hz}
    control_channels: list = field(default_factory=list)  # hunt list (Hz)
    modulation: str = "C4FM"      # C4FM | CQPSK (p25)
    symbol_rate: float = 0.0      # EDACS: 9600; Moto: 3600; P25: 4800
    esk: bool = False             # EDACS encryption-scrambled keying
    cmd_offset: int | None = None  # Moto per-system OSW command offset
    force_p25: bool = False       # Moto: treat digital grants as P25
    system_uuid: str = ""
    transmit_site_uuid: str = ""
    bandwidth: float = 12500.0
    blacklist: set = field(default_factory=set)    # talkgroups never recorded
    whitelist: set | None = None                   # if set, only these

    def __post_init__(self):
        if not self.symbol_rate:
            self.symbol_rate = {"p25": 4800.0, "edacs": 9600.0,
                                "moto": 3600.0}.get(self.type, 4800.0)
        if not self.control_channels and self.channels:
            self.control_channels = list(self.channels.values())
        if not self.system_uuid:
            self.system_uuid = str(_uuid.uuid4())
        if not self.transmit_site_uuid:
            self.transmit_site_uuid = str(_uuid.uuid4())


@dataclass
class RcConfig:
    """Top-level deployment config (reference ``rc_config``)."""
    sources: dict = field(default_factory=dict)    # {index: SourceConfig}
    systems: dict = field(default_factory=dict)    # {index: SystemConfig}
    frontend_mode: str = "xlat"   # 'xlat' | 'pfb' (rc_frontend/receiver.py:242)
    receiver_split2: bool = False
    redis_servers: list = field(default_factory=list)  # [{host, port}]
    activemq: dict | None = None  # {host, port}: STOMP durable tier
    site_uuid: str = field(default_factory=lambda: str(_uuid.uuid4()))
    blacklists: dict = field(default_factory=dict)
    scan_mode: bool = False
    audio_dir: str = "audio"
    # TPU-native additions: slot-pool sizing for the batched pipelines.
    num_slots_per_source: int = 64
    block_seconds: float = 0.1    # streaming block length
    # Batch same-rate sources into grouped vmapped pipeline steps
    # (required to hold real time on TPU hosts — the tracking scans are
    # latency-bound per call, PERF.md §12). CPU-only offline decode of
    # multi-source configs may set False: with no MXU to underfeed the
    # per-source form measured ~1.3x faster there.
    group_sources: bool = True
    # Live-SDR blocks ship host->device as bfloat16 re/im (half the
    # float32 stream; PERF.md §6). Applied per source only where the
    # wire format makes it lossless (8-bit cu8/cs8, e.g. rtl_tcp) —
    # bf16's 8-bit mantissa would truncate 12-16-bit cs16/cf32 sources,
    # so those stay float32 regardless of this knob. File replay is
    # always float32 for capture fidelity.
    ingest_bf16: bool = True

    @classmethod
    def from_dict(cls, d: dict) -> "RcConfig":
        cfg = cls()
        for idx, s in d.get("sources", {}).items():
            cfg.sources[idx] = (s if isinstance(s, SourceConfig)
                                else SourceConfig(**s))
        for idx, s in d.get("systems", {}).items():
            cfg.systems[idx] = (s if isinstance(s, SystemConfig)
                                else SystemConfig(**s))
        for k in ("frontend_mode", "receiver_split2", "redis_servers",
                  "activemq", "site_uuid", "blacklists", "scan_mode",
                  "audio_dir", "num_slots_per_source", "block_seconds",
                  "ingest_bf16", "group_sources"):
            if k in d:
                setattr(cfg, k, d[k])
        return cfg


def load_config(path: str) -> RcConfig:
    """Execute a deployment config file; it must define ``config``
    (an RcConfig) or ``rc_config`` (a dict or class instance)."""
    ns: dict = {"RcConfig": RcConfig, "SourceConfig": SourceConfig,
                "SystemConfig": SystemConfig}
    with open(path) as f:
        exec(compile(f.read(), path, "exec"), ns)
    cfg = ns.get("config") or ns.get("rc_config")
    if isinstance(cfg, RcConfig):
        return cfg
    if isinstance(cfg, dict):
        return RcConfig.from_dict(cfg)
    raise ValueError(f"{path} defines no `config`/`rc_config`")
