"""Call management: grants → call lifecycle → recorder events.

Re-implements the reference's per-protocol call managers
(p25_call_manager.py, moto_call_manager.py, edacs_call_manager.py) with
the same behavior-defining state machines:

- **continuation dedup**: a grant matching an open call's channel+group
  (and user, unless either side is 0) refreshes ``time_activity``
  instead of opening a new call (p25_call_manager.py:128-132).
- **conflict kill** (P25): a grant on a channel carrying a *different*
  group — or the same group with a different nonzero user — closes the
  existing call first (p25_call_manager.py:134-139).
- **cross-site merge**: a system-wide call with the same group (and
  compatible user) opened < 1 s ago shares its ``call_uuid``, so one
  transmission heard by N sites records once per site under one id
  (p25_call_manager.py:150-164).
- **hang-time timeout**: calls idle past their protocol hang time are
  closed by a periodic sweep — P25 5 s, Moto 1 s, EDACS 0.5 s
  (p25_call_manager.py:36,231-253; moto:37; edacs:37).
- **CDR vocabulary**: identical field names so downstream consumers
  (recorder, uploader, website) port unchanged
  (p25_call_manager.py:196-216).

Events emitted on the bus: ``/topic/call_management/new_call/<instance>``
and ``/topic/call_management/timeout/<instance>``.

Deterministic by construction: the clock is injected (``now_fn``) and
timeouts run from an explicit ``sweep()`` — the production loop calls it
every 100 ms (reference thread cadence), tests call it directly.
"""

from __future__ import annotations

import logging
import threading
import time
import uuid as _uuid
from typing import Callable


class CallManagerBase:
    demod_type = "base"
    hang_time = 5.0

    def __init__(self, bus, get_instance: Callable[[str], dict | None],
                 now_fn: Callable[[], float] = time.time,
                 publish_call_table: Callable[[str, dict], None]
                 | None = None,
                 blacklists: dict | None = None,
                 whitelists: dict | None = None):
        """``blacklists``/``whitelists``: {system key: iterable of
        talkgroups} keyed by system_uuid or the config's numeric/string
        system id — the reference's ``config.blacklists`` vocabulary
        (config_denver_realistic_p25.py:273-364; stored but never
        enforced in the reference's live path, so the semantics here are
        the documented intent: blacklisted groups are never recorded, and
        with a whitelist present only listed groups are)."""
        self.log = logging.getLogger(
            f"overseer.{self.demod_type}_call_manager")
        self.bus = bus
        self.get_instance = get_instance
        self.now = now_fn
        self.publish_call_table = publish_call_table or (lambda i, t: None)
        self.blacklists = {k: frozenset(v)
                           for k, v in (blacklists or {}).items()}
        self.whitelists = {k: frozenset(v)
                           for k, v in (whitelists or {}).items()}
        self.instance_metadata: dict[str, dict] = {}
        self.system_metadata: dict[str, dict] = {}
        self._locks: dict[str, threading.RLock] = {}
        self._subscribed: set[str] = set()
        #: cross-site merge window: calls for the same (group, user)
        #: opened within this many seconds anywhere in the system share
        #: one call_uuid (reference hard-codes 1 s,
        #: p25_call_manager.py:150-164).
        self.merge_window_s = 1.0

    # ---- demod lifecycle (notify_demod_new/expire contract) ----
    def notify_demod_new(self, dtype: str, instance_uuid: str,
                         record: dict | None = None) -> None:
        if dtype != self.demod_type or instance_uuid in self._subscribed:
            return
        self._subscribed.add(instance_uuid)
        self._locks[instance_uuid] = threading.RLock()
        self.bus.subscribe(f"/topic/raw_control/{instance_uuid}",
                           lambda ev, u=instance_uuid:
                           self.process_raw_control(u, ev))
        self.bus.subscribe(f"/topic/raw_voice/{instance_uuid}",
                           lambda ev, u=instance_uuid:
                           self.process_raw_voice(u, ev))

    def notify_demod_expire(self, dtype: str, instance_uuid: str) -> None:
        if instance_uuid in self._subscribed:
            self._subscribed.discard(instance_uuid)
            self.bus.unsubscribe(f"/topic/raw_control/{instance_uuid}")
            self.bus.unsubscribe(f"/topic/raw_voice/{instance_uuid}")

    # ---- table plumbing ----
    def _lock(self, instance_uuid: str) -> threading.RLock:
        return self._locks.setdefault(instance_uuid, threading.RLock())

    def _tables(self, instance_uuid: str) -> tuple[dict, dict] | None:
        """(instance call table, system call table) or None if the demod
        vanished from presence."""
        inst = self.get_instance(instance_uuid)
        if not inst:
            return None
        system_uuid = inst.get("system_uuid")
        im = self.instance_metadata.setdefault(
            instance_uuid, {"channel_identifier_table": {}, "patches": {},
                            "call_table": {}})
        sm = self.system_metadata.setdefault(system_uuid, {"call_table": {}})
        return im["call_table"], sm["call_table"]

    def close_call(self, instance_uuid: str, call_uuid: str) -> None:
        tabs = self._tables(instance_uuid)
        if tabs is None:
            return
        ict, sct = tabs
        if call_uuid not in ict:
            return
        self.bus.send_event_lazy(
            f"/topic/call_management/timeout/{instance_uuid}",
            {"call_uuid": call_uuid, "instance_uuid": instance_uuid})
        self.log.info("CLOSE: %s %s", instance_uuid, call_uuid)
        ict.pop(call_uuid, None)
        entry = sct.get(call_uuid)
        if entry is not None:
            entry.get("instances", {}).pop(instance_uuid, None)
            if not entry.get("instances"):
                sct.pop(call_uuid, None)

    def group_filtered(self, instance_uuid: str, group_address: int) -> bool:
        """True if this talkgroup must not be recorded on this system."""
        if not (self.blacklists or self.whitelists):
            return False
        inst = self.get_instance(instance_uuid) or {}
        keys = [k for k in (inst.get("system_uuid"),
                            inst.get("system_id_local")) if k is not None]
        for k in keys:
            if group_address in self.blacklists.get(k, ()):
                return True
        for k in keys:
            wl = self.whitelists.get(k)
            if wl is not None:
                return group_address not in wl
        return False

    # ---- the core grant state machine ----
    def call_user_to_group(self, instance_uuid: str, channel_key,
                           group_address: int, user_address: int = 0,
                           *, cdr_extra: dict | None = None,
                           frequency: float | None = None,
                           bandwidth: float = 12500.0,
                           modulation_type: str = "analog",
                           slot=0,
                           conflict_kill: bool = False) -> bool:
        """``channel_key`` is the protocol's local channel identity (P25
        channel word / Moto+EDACS frequency); ``frequency`` the absolute
        Hz to record (defaults to channel_key for freq-keyed protocols).
        """
        if self.group_filtered(instance_uuid, group_address):
            self.log.debug("FILTERED: %s group %s", instance_uuid,
                           group_address)
            return False
        with self._lock(instance_uuid):
            tabs = self._tables(instance_uuid)
            if tabs is None:
                return False
            ict, sct = tabs
            now = self.now()

            closed = []
            for cu in list(ict):
                c = ict.get(cu)
                if c is None or c["system_channel_local"] != channel_key:
                    continue
                if c["system_group_local"] == group_address and (
                        user_address == 0 or
                        c["system_user_local"] == user_address):
                    c["time_activity"] = now
                    return True
                if conflict_kill:
                    if c["system_group_local"] != group_address:
                        closed.append(cu)
                    elif (user_address != 0 and
                          c["system_user_local"] not in (0, user_address)):
                        closed.append(cu)
            for cu in closed:
                self.close_call(instance_uuid, cu)

            # Cross-site merge: same group/user opened <1 s ago anywhere
            # in the system shares the call_uuid.
            call_uuid = None
            for cu in list(sct):
                c = sct.get(cu)
                if c is None:
                    continue
                if c["system_group_local"] == group_address and (
                        user_address == 0 or
                        c["system_user_local"] == user_address) and \
                        now - c["time_open"] < self.merge_window_s:
                    call_uuid = c["call_uuid"]
                    break
            if call_uuid is None:
                call_uuid = str(_uuid.uuid4())

            inst = self.get_instance(instance_uuid) or {}
            cdr = {
                "call_uuid": call_uuid,
                "system_id": inst.get("system_uuid"),
                "transmit_site_uuid": inst.get("transmit_site_uuid"),
                "instance_uuid": instance_uuid,
                "system_group_local": group_address,
                "system_user_local": user_address,
                "system_channel_local": channel_key,
                "type": "group",
                "frequency": (channel_key if frequency is None
                              else frequency),
                "channel_bandwidth": bandwidth,
                "modulation_type": modulation_type,
                "slot": slot,
                "hang_time": self.hang_time,
                "time_open": now,
                "time_activity": now,
            }
            cdr.update(cdr_extra or {})
            ict[call_uuid] = cdr
            if call_uuid not in sct:
                sct[call_uuid] = dict(cdr, instances={instance_uuid: True})
            else:
                sct[call_uuid]["instances"][instance_uuid] = True
            self.bus.send_event_lazy(
                f"/topic/call_management/new_call/{instance_uuid}", cdr)
            self.publish_call_table(instance_uuid, ict)
            self.log.info("OPEN: %s %s %s %s", instance_uuid, call_uuid,
                          group_address, user_address)
            return True

    # ---- hang-time sweep (reference periodic_timeout_thread) ----
    def sweep(self) -> int:
        now = self.now()
        n_closed = 0
        for instance_uuid in list(self.instance_metadata):
            with self._lock(instance_uuid):
                tabs = self._tables(instance_uuid)
                if tabs is None:
                    continue
                ict, _ = tabs
                for cu in list(ict):
                    c = ict.get(cu)
                    if c and now - c["time_activity"] > c["hang_time"]:
                        self.close_call(instance_uuid, cu)
                        n_closed += 1
                if n_closed:
                    self.publish_call_table(instance_uuid, ict)
        return n_closed

    def run_sweeper(self, stop_event: threading.Event,
                    period: float = 0.1) -> threading.Thread:
        def loop():
            while not stop_event.wait(period):
                self.sweep()
        t = threading.Thread(target=loop, daemon=True,
                             name=f"{self.demod_type}-cm-sweep")
        t.start()
        return t

    # subclass hooks
    def process_raw_control(self, instance_uuid: str, t: dict) -> None:
        raise NotImplementedError

    def process_raw_voice(self, instance_uuid: str, t: dict) -> None:
        pass


class P25CallManager(CallManagerBase):
    """P25: channel-word-keyed grants with IDEN table resolution, TDMA
    modulation typing, voice-channel LC/TLC feedback."""

    demod_type = "p25"
    hang_time = 5.0

    def get_channel_detail(self, instance_uuid: str, channel: int):
        """(freq_hz, bw_hz, slot, access) from the per-instance IDEN
        table (p25_call_manager.py:67-82)."""
        import math
        ident = (channel & 0xF000) >> 12
        number = channel & 0x0FFF
        table = self.instance_metadata.get(instance_uuid, {}).get(
            "channel_identifier_table", {})
        e = table.get(ident)
        if e is None:
            return False, False, False, False
        freq = math.floor((e["Base Frequency"] + (number // e["Slots"])
                           * (e["Channel Spacing"] / 1000.0)) * 1e6)
        return freq, e["BW"] * 1000.0, number % e["Slots"], e["Type"]

    def _grant(self, instance_uuid: str, channel: int, group: int,
               user: int = 0) -> bool:
        freq, bw, slot, access = self.get_channel_detail(instance_uuid,
                                                         channel)
        if freq is False:
            return False
        inst = self.get_instance(instance_uuid) or {}
        sysmod = inst.get("system_modulation", "C4FM")
        modulation_type = {
            ("FDMA", "C4FM"): "p25", ("TDMA", "C4FM"): "p25_tdma",
            ("FDMA", "CQPSK"): "p25_cqpsk",
            ("TDMA", "CQPSK"): "p25_cqpsk_tdma",
        }.get((access, sysmod), f"ERROR {access} {sysmod}")
        site = inst.get("site_detail", {}) or {}
        return self.call_user_to_group(
            instance_uuid, channel, group, user,
            frequency=freq, bandwidth=bw, slot=slot,
            modulation_type=modulation_type, conflict_kill=True,
            cdr_extra={"p25_wacn": site.get("WACN ID") or 0x0,
                       "p25_system_id": site.get("System ID") or 0x0,
                       "p25_nac": site.get("NAC") or 0x0})

    def process_raw_control(self, instance_uuid: str, t: dict) -> None:
        if t.get("crc", 0) != 0:
            return
        tabs = self._tables(instance_uuid)
        if tabs is None:
            return
        name = t.get("name")
        with self._lock(instance_uuid):
            im = self.instance_metadata[instance_uuid]
            cit = im["channel_identifier_table"]
            if name == "IDEN_UP_VU":
                cit[t["Identifier"]] = {
                    "BW": t["BW VU"], "Base Frequency": t["Base Frequency"],
                    "Channel Spacing": t["Channel Spacing"],
                    "Transmit Offset": t["Transmit Offset VU"],
                    "Type": "FDMA", "Slots": 1}
            elif name == "IDEN_UP":
                cit[t["Identifier"]] = {
                    "BW": t["BW"], "Base Frequency": t["Base Frequency"],
                    "Channel Spacing": t["Channel Spacing"],
                    "Transmit Offset": t["Transmit Offset"],
                    "Type": "FDMA", "Slots": 1}
            elif name == "IDEN_UP_TDMA":
                cit[t["Identifier"]] = {
                    "BW": t["BW"], "Base Frequency": t["Base Frequency"],
                    "Channel Spacing": t["Channel Spacing"],
                    "Transmit Offset": t["Transmit Offset TDMA"],
                    "Type": t["Access Type"], "Slots": t["Slots"]}
            elif name in ("GRP_V_CH_GRANT", "MOT_PAT_GRP_VOICE_CHAN_GRANT"):
                group = t.get("Group Address", t.get("Super Group"))
                self._grant(instance_uuid, t["Channel"], group,
                            t.get("Source Address", 0))
            elif name == "GRP_V_CH_GRANT_UPDT":
                self._grant(instance_uuid, t["Channel 0"],
                            t["Group Address 0"])
                self._grant(instance_uuid, t["Channel 1"],
                            t["Group Address 1"])
            elif name == "MOT_PAT_GRP_VOICE_CHAN_GRANT_UPDT":
                self._grant(instance_uuid, t["Channel 0"],
                            t["Super Group 0"])
                self._grant(instance_uuid, t["Channel 1"],
                            t["Super Group 1"])

    def process_raw_voice(self, instance_uuid: str, t: dict) -> None:
        """Voice-channel feedback from the recorder's frame sensor:
        TLC 'Call Termination' closes early; LDU 'Group Voice Channel
        User' keeps the call alive and backfills the user
        (p25_call_manager.py:347-372)."""
        try:
            pkt = t["packet"]
            lc = pkt.get("lc", {})
        except (KeyError, TypeError):
            return
        tabs = self._tables(instance_uuid)
        if tabs is None:
            return
        ict, _ = tabs
        lcf = lc.get("lcf_long")
        with self._lock(instance_uuid):
            if pkt.get("short") == "TLC" and \
                    lcf == "Call Termination / Cancellation":
                c = ict.get(t.get("call_uuid"))
                if c and self.now() - c["time_open"] > 0.2:
                    self.close_call(instance_uuid, t["call_uuid"])
            elif lcf == "Group Voice Channel User":
                c = ict.get(t.get("call_uuid"))
                channel = c["system_channel_local"] if c else -1
                if c and c["system_user_local"] == 0 and \
                        lc.get("source_id", 0) != 0:
                    c["system_user_local"] = lc["source_id"]
                if channel != -1:
                    self.call_user_to_group(
                        instance_uuid, channel, lc["tgid"],
                        lc.get("source_id", 0), conflict_kill=True)
            elif lcf == "Group Voice Channel Update":
                self._grant(instance_uuid, lc["channel_a"],
                            lc["channel_a_group"])
                self._grant(instance_uuid, lc["channel_b"],
                            lc["channel_b_group"])


class MotoCallManager(CallManagerBase):
    """Motorola Type II: frequency-keyed calls; Analog/Digital Call and
    Call Continuation events (moto_call_manager.py:199-209)."""

    demod_type = "moto"
    hang_time = 1.0

    def process_raw_control(self, instance_uuid: str, t: dict) -> None:
        tabs = self._tables(instance_uuid)
        if tabs is None:
            return
        typ = t.get("type")
        if typ == "Analog Call":
            self.call_user_to_group(
                instance_uuid, t["frequency"], t["tg"], t["user_local"],
                modulation_type="analog")
        elif typ == "Digital Call":
            self.call_user_to_group(
                instance_uuid, t["frequency"], t["tg"], t["user_local"],
                modulation_type="p25")
        elif typ == "Call Continuation":
            self.call_user_to_group(
                instance_uuid, t["frequency"], t["tg"],
                t.get("user_local", 0), modulation_type="analog")


class EdacsCallManager(CallManagerBase):
    """EDACS: frequency-keyed; analog assignment/continuation plus
    ProVoice digital continuation (edacs_call_manager.py:165-175)."""

    demod_type = "edacs"
    hang_time = 0.5

    def process_raw_control(self, instance_uuid: str, t: dict) -> None:
        tabs = self._tables(instance_uuid)
        if tabs is None:
            return
        typ = t.get("type")
        if typ == "call_assignment_analog":
            self.call_user_to_group(
                instance_uuid, t["frequency"], t["group"], t["logical_id"],
                modulation_type="analog_edacs")
        elif typ == "call_continuation_analog":
            self.call_user_to_group(
                instance_uuid, t["frequency"], t["id"], 0,
                modulation_type="analog_edacs")
        elif typ == "call_continuation_digital":
            self.call_user_to_group(
                instance_uuid, t["frequency"], t["id"], 0,
                modulation_type="provoice")
