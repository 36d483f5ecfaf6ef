"""CommandEnv: master connection + cluster-wide exclusive admin lock
(ref: weed/shell/commands.go:28-78, wdclient/exclusive_locks/).

Copied from the JAX package's shell/command_env.py, with one repair: a
release waits for a lease renewal in flight, which the JAX copy cancels;
the master may have granted that renewal a new token, and a release of
the old one then left the lock held for a whole lease."""

from __future__ import annotations

import asyncio
from typing import Optional

from ..pb import grpc_address
from ..pb.rpc import Stub


class NotLockedError(Exception):
    pass


class CommandEnv:
    def __init__(self, master: str, renew_interval: float = 4.0):
        self.master = master
        self.master_stub = Stub(grpc_address(master), "master")
        # lease renewal cadence (ref exclusive_locker.go:14-18 — renewed
        # every 4s against a 10s lease)
        self.renew_interval = renew_interval
        self._admin_token: Optional[int] = None
        self._renew_task: Optional[asyncio.Task] = None
        self._renewal: Optional[asyncio.Future] = None

    def volume_stub(self, url: str) -> Stub:
        return Stub(grpc_address(url), "volume")

    # --- exclusive lock (ref exclusive_locker.go:14-60) ---
    async def acquire_lock(self) -> None:
        resp = await self.master_stub.call(
            "LeaseAdminToken", {"previous_token": self._admin_token or 0}
        )
        if resp.get("error"):
            raise RuntimeError(f"lock: {resp['error']}")
        self._admin_token = int(resp["token"])
        self._renew_task = asyncio.ensure_future(self._renew_loop())

    async def _renew_loop(self) -> None:
        while self._admin_token is not None:
            await asyncio.sleep(self.renew_interval)
            # shielded: a release that cancels this loop mid-renewal waits
            # for the renewal instead, because the master may already have
            # granted a new token that only its answer carries
            self._renewal = asyncio.ensure_future(self._renew_once())
            await asyncio.shield(self._renewal)

    async def _renew_once(self) -> None:
        try:
            resp = await self.master_stub.call(
                "LeaseAdminToken", {"previous_token": self._admin_token}
            )
            if not resp.get("error"):
                self._admin_token = int(resp["token"])
        except Exception:
            pass

    async def release_lock(self) -> None:
        if self._renew_task is not None:
            self._renew_task.cancel()
            self._renew_task = None
        if self._renewal is not None:
            await self._renewal  # never raises: _renew_once catches
            self._renewal = None
        if self._admin_token is not None:
            try:
                await self.master_stub.call(
                    "ReleaseAdminToken", {"previous_token": self._admin_token}
                )
            except Exception:
                pass
            self._admin_token = None

    def confirm_is_locked(self) -> None:
        if self._admin_token is None:
            raise NotLockedError(
                "need to run `lock` before a mutating command (and `unlock` after)"
            )

    # --- cluster info ---
    async def collect_topology(self) -> dict:
        resp = await self.master_stub.call("VolumeList", {})
        return resp.get("topology_info", {})

    async def collect_data_nodes(self) -> list[dict]:
        """Flat data-node list with volumes/ec shards/free slots."""
        topo = await self.collect_topology()
        nodes = []
        for dc in topo.get("data_centers", []):
            for rack in dc.get("racks", []):
                for dn in rack.get("data_nodes", []):
                    dn = dict(dn)
                    dn["data_center"] = dc["id"]
                    dn["rack"] = rack["id"]
                    nodes.append(dn)
        return nodes
