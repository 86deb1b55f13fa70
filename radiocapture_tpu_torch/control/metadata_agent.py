"""Site-metadata agent: diff decoded site parameters, publish changes.

Replaces the reference's ``p25_metadata_agent.py`` (:169-287): it
subscribes to every live demod's ``/topic/raw_control/*`` stream, tracks
per-instance site parameters (frequency-identifier tables from IDEN_UP*,
WACN/System IDs + control channel from NET_STS_BCST, RFSS/Site IDs from
RFSS_STS_BCST), and publishes only *changes* to the durable
``/queue/metadata/site_update`` queue that feeds the website database —
each message carrying transmit/receive site UUIDs, the parameter name
(``FIT-<n>``, ``WACN ID``, ...) and the new value.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable

log = logging.getLogger(__name__)


class MetadataAgent:
    """bus: InProcBus/RedisBus; get_instance(uuid) -> presence record
    (needs 'transmit_site_uuid' and 'site_uuid')."""

    def __init__(self, bus, get_instance: Callable[[str], dict | None]):
        self.bus = bus
        self.get_instance = get_instance
        self._lock = threading.RLock()
        # {instance: {'channel_identifier_table': {}, <param>: value}}
        self.instance_metadata: dict[str, dict] = {}
        self._subs: dict[str, Callable] = {}

    # -- demod lifecycle (driven by DemodManager callbacks) -------------
    def notify_demod_new(self, dtype: str, instance_uuid: str,
                         record: dict | None = None) -> None:
        with self._lock:
            self.instance_metadata.setdefault(
                instance_uuid, {"channel_identifier_table": {}})
            if instance_uuid not in self._subs:
                cb = (lambda ev, u=instance_uuid:
                      self._on_raw_control(u, ev))
                self._subs[instance_uuid] = cb
                self.bus.subscribe("/topic/raw_control/%s" % instance_uuid,
                                   cb)

    def notify_demod_expire(self, dtype: str, instance_uuid: str) -> None:
        with self._lock:
            self.instance_metadata.pop(instance_uuid, None)
            cb = self._subs.pop(instance_uuid, None)
        if cb is not None and hasattr(self.bus, "unsubscribe"):
            self.bus.unsubscribe("/topic/raw_control/%s" % instance_uuid,
                                 cb)

    # -- parameter diffing (p25_metadata_agent.py:120-167) --------------
    def _is_updated(self, instance_uuid: str, parameter: str,
                    value) -> bool:
        with self._lock:
            meta = self.instance_metadata.setdefault(
                instance_uuid, {"channel_identifier_table": {}})
            if meta.get(parameter) == value:
                return False
            meta[parameter] = value
            return True

    def _get_channel_detail(self, instance_uuid: str, channel: int):
        meta = self.instance_metadata.get(instance_uuid, {})
        table = meta.get("channel_identifier_table", {})
        ident = (channel & 0xF000) >> 12
        number = channel & 0x0FFF
        entry = table.get(ident)
        if entry is None:
            return False, False
        freq_mhz = entry["Base Frequency"] + number / entry.get(
            "Slots", 1) * (entry["Channel Spacing"] / 1000.0)
        return int(freq_mhz * 1e6), entry["BW"] * 1000.0

    def _on_raw_control(self, instance_uuid: str, t: dict) -> None:
        inst = self.get_instance(instance_uuid)
        if inst is None:
            return
        # Don't work with bad data (p25_metadata_agent.py:188-189).
        if "crc" in t and t["crc"] != 0:
            return
        name = t.get("name")
        to_check: list[dict] = []
        with self._lock:
            meta = self.instance_metadata.setdefault(
                instance_uuid, {"channel_identifier_table": {}})
            if name in ("IDEN_UP", "IDEN_UP_VU", "IDEN_UP_TDMA"):
                if name == "IDEN_UP_VU":
                    value = {"BW": t["BW VU"],
                             "Base Frequency": t["Base Frequency"],
                             "Channel Spacing": t["Channel Spacing"],
                             "Transmit Offset": t["Transmit Offset VU"],
                             "Type": "FDMA", "Slots": 1}
                elif name == "IDEN_UP":
                    value = {"BW": t["BW"],
                             "Base Frequency": t["Base Frequency"],
                             "Channel Spacing": t["Channel Spacing"],
                             "Transmit Offset": t["Transmit Offset"],
                             "Type": "FDMA", "Slots": 1}
                else:
                    value = {"BW": t["BW"],
                             "Base Frequency": t["Base Frequency"],
                             "Channel Spacing": t["Channel Spacing"],
                             "Transmit Offset": t["Transmit Offset TDMA"],
                             "Type": t["Access Type"],
                             "Slots": t["Slots"]}
                to_check.append({"parameter": "FIT-%s" % t["Identifier"],
                                 "value": value})
                meta["channel_identifier_table"][t["Identifier"]] = value
            elif name == "NET_STS_BCST":
                to_check.append({"parameter": "WACN ID",
                                 "value": hex(int(t["WACN ID"]))})
                to_check.append({"parameter": "System ID",
                                 "value": hex(int(t["System ID"]))})
                to_check.append({"parameter": "System Service Class",
                                 "value": t["System Service Class"]})
                freq, bw = self._get_channel_detail(instance_uuid,
                                                    t["Channel"])
                if freq is not False:
                    to_check.append({"parameter": "Control Channel",
                                     "value": {"frequency": freq,
                                               "bandwidth": bw}})
            elif name == "RFSS_STS_BCST":
                to_check.append({"parameter": "Site ID",
                                 "value": t["Site ID"]})
                to_check.append({"parameter": "RF Sub-system ID",
                                 "value": t["RF Sub-system ID"]})
                to_check.append({"parameter": "RFSS Network Connection",
                                 "value": t["A"]})
        for d in to_check:
            if self._is_updated(instance_uuid, d["parameter"], d["value"]):
                log.info("Updated! %s %s %s", instance_uuid,
                         d["parameter"], d["value"])
                self.bus.send_event_hopeful("/queue/metadata/site_update", {
                    "transmit_site_uuid": inst.get("transmit_site_uuid"),
                    "receive_site_uuid": inst.get("site_uuid"),
                    "parameter": d["parameter"],
                    "value": d["value"],
                })
