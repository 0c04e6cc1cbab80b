"""Worker recycling: bounded-lifetime serving processes with zero-drop
restarts via listen-socket handoff.

Why this exists: a PJRT plugin or library that leaks *host* memory per
device transfer makes any long serving soak grow RSS linearly no matter
how bounded the framework's own caches are. The production answer —
same as gunicorn's ``max_requests`` / uWSGI's ``reload-on-rss`` — is to
recycle the worker
process before the leak matters.

Design (single process, no proxy tier):

- A monitor thread watches two budgets: served ``/compute`` requests
  (``--recycle-after-requests``) and current VmRSS
  (``--recycle-rss-mb``). When a budget is exceeded it waits for a moment
  with no in-flight HTTP requests, flips the app into *draining* mode
  (responses carry ``Connection: close`` so keep-alive sessions quiesce),
  and stops the accept loop.
- The main thread then re-``exec``s the server with its original argv.
  The **listening socket survives the exec** (made inheritable, fd passed
  via ``IVT_INHERIT_SOCKET``): connections arriving during the reboot sit
  in the kernel listen backlog instead of being refused, so clients just
  observe one slow request, never a dropped one.
- The new generation (``IVT_GENERATION`` increments; surfaced in
  ``/metrics``) re-registers models and reuses the persistent XLA
  compilation cache (``--jit-cache``), so the restart costs seconds, not
  a cold-compile storm.

The reference app has no analog (a Django dev server holds no device
state worth recycling); this bounds a worker's lifetime for week-long
soaks.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time

logger = logging.getLogger(__name__)


def rss_mb() -> float:
    """Current VmRSS in MB from /proc (Linux; 0.0 where unavailable).

    Current RSS, not ``ru_maxrss``: the peak is monotone by definition and
    says nothing about whether memory was given back (a soak "leak" read
    off ru_maxrss is not leak evidence — ROADMAP round-3 sixth session).
    """
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


class Recycler:
    """Watches budgets, quiesces the server, and re-execs it in place."""

    def __init__(
        self,
        app,
        max_compute_requests: int = 0,
        max_rss_mb: int = 0,
        check_interval_s: float = 1.0,
        drain_timeout_s: float = 60.0,
        min_uptime_s: float = 10.0,
    ):
        self.app = app
        self.max_compute_requests = max_compute_requests
        self.max_rss_mb = max_rss_mb
        self.check_interval_s = check_interval_s
        self.drain_timeout_s = drain_timeout_s
        # an RSS threshold below the process's natural working set would
        # recycle in a tight boot loop; refuse to trigger before the
        # server has been up (and presumably warmed) for a minimum while
        self.min_uptime_s = min_uptime_s
        self._httpd = None
        self._due_reason: str = ""
        self._started = time.monotonic()
        self._thread: threading.Thread | None = None

    # -- budget checks -------------------------------------------------------
    def due_reason(self) -> str:
        """Non-empty human-readable reason when a budget is exceeded."""
        if self.max_compute_requests > 0:
            served = self.app.metrics.counters.get("compute_requests", 0)
            if served >= self.max_compute_requests:
                return (f"served {served} compute requests "
                        f">= budget {self.max_compute_requests}")
        if self.max_rss_mb > 0:
            cur = rss_mb()
            if cur >= self.max_rss_mb:
                if time.monotonic() - self._started < self.min_uptime_s:
                    # over threshold at boot = threshold below the working
                    # set; recycling would just boot-loop. Disable the RSS
                    # trigger for this generation (a later generation re-
                    # checks: exec resets the clock AND the working set)
                    logger.warning(
                        "RSS %.0f MB already over the %d MB recycle "
                        "threshold within %.0fs of boot — threshold is "
                        "below the working set; disabling the RSS trigger",
                        cur, self.max_rss_mb, self.min_uptime_s)
                    self.max_rss_mb = 0
                    return ""
                return f"VmRSS {cur:.0f} MB >= budget {self.max_rss_mb} MB"
        return ""

    # -- lifecycle -----------------------------------------------------------
    def start(self, httpd) -> None:
        """Begin monitoring; ``httpd.serve_forever()`` will return once a
        recycle is due and the app has quiesced."""
        self._httpd = httpd
        self._thread = threading.Thread(
            target=self._monitor, name="recycler", daemon=True)
        self._thread.start()

    def _monitor(self) -> None:
        while True:
            time.sleep(self.check_interval_s)
            reason = self.due_reason()
            if not reason:
                continue
            logger.info("recycle due: %s — draining", reason)
            self._due_reason = reason
            # Order matters under sustained load: stop ACCEPTING first
            # (newcomers queue, unaccepted, in the kernel listen backlog
            # and become the next generation's first requests), THEN wait
            # for accepted requests to finish. Draining the other way
            # never quiesces — concurrent clients keep inflight > 0
            # forever and the drain timeout kills their requests at exec
            # (measured: one RemoteDisconnected per client on the first
            # CPU soak of this feature).
            self.app.draining = True  # responses carry Connection: close
            self._httpd.shutdown()    # serve_forever returns in main thread
            deadline = time.monotonic() + self.drain_timeout_s
            settled = 0
            while time.monotonic() < deadline:
                if self.app.inflight == 0:
                    settled += 1
                    # require a stable zero: a request parsed on a still-
                    # open keep-alive connection right at the zero reading
                    # would be killed by the exec
                    if settled >= 3:
                        break
                else:
                    settled = 0
                time.sleep(0.1)
            if self.app.inflight:
                logger.warning(
                    "drain timeout with %d requests still in flight; "
                    "recycling anyway", self.app.inflight)
            return

    def exec_next(self, sock, argv=None) -> None:
        """Replace this process with a fresh generation, handing ``sock``
        (the listening socket) across the exec. Does not return.

        Connections arriving between shutdown() and the next generation's
        accept loop queue in the kernel backlog of ``sock`` — no
        connection-refused window.
        """
        generation = getattr(self.app, "generation", 0)
        try:
            # persist the served-program inventory (+ lifetime
            # speculation counters) so the next generation warms exactly
            # what this one served instead of re-staging every signature
            # on demand mid-traffic (serving/inventory.py; VERDICT r4
            # weak #1). Best-effort: a failed save just means the next
            # generation boots cold, as before this feature.
            if getattr(self.app, "save_inventory", None) is not None:
                self.app.save_inventory()
        except Exception as err:  # noqa: BLE001
            logger.warning("inventory save failed: %s", err)
        os.set_inheritable(sock.fileno(), True)
        env = dict(os.environ)
        env["IVT_INHERIT_SOCKET"] = str(sock.fileno())
        env["IVT_GENERATION"] = str(generation + 1)
        argv = list(sys.argv[1:] if argv is None else argv)
        cmd = [sys.executable, "-m",
               "interactive_vit_tpu.serving.server"] + argv
        logger.info("recycling (generation %d -> %d): %s",
                    generation, generation + 1, self._due_reason)
        # flush stdio so the generations' logs don't interleave corruptly
        sys.stdout.flush()
        sys.stderr.flush()
        os.execve(sys.executable, cmd, env)
