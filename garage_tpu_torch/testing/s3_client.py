"""Minimal signing S3 client for the in-process drills.

The port's copy of the reference harness's client (``bench._S3``): one
SigV4-signed aiohttp request per call against an S3 API server on
127.0.0.1, signed with the port's ``api/signature.py``, over an aiohttp
session the caller owns.  SimCluster's traffic driver, the drills and the
dev cluster's smoke tools use it.
"""

from __future__ import annotations

import asyncio
import time

from ..api.signature import sign_request, uri_encode


class S3Client:
    """Minimal SigV4 client against the in-process server."""

    def __init__(self, session, port, kid, secret,
                 honor_retry_after=False, retry_after_cap=2.0):
        self.session, self.port, self.kid, self.secret = (
            session, port, kid, secret)
        # opt-in 503 Retry-After honoring (clamped): a production-shaped
        # client pauses before its NEXT request instead of hammering a
        # shedding gateway.  Off by default — the overload/noisy drills
        # calibrate their offered load with a fixed post-shed backoff
        # and must keep it, or "4x capacity" stops meaning 4x.
        self.honor_retry_after = honor_retry_after
        self.retry_after_cap = retry_after_cap
        self._backoff_until = 0.0

    async def req(self, method, path, body=b"", query=(), headers=None):
        """(status, body, response headers) of one signed request; `path`
        is the wire form and is signed verbatim, `headers` are sent (and
        signed) beside the host header."""
        import yarl

        if self.honor_retry_after:
            wait = self._backoff_until - time.monotonic()
            if wait > 0:
                await asyncio.sleep(min(wait, self.retry_after_cap))
        headers = dict(headers or {}, host=f"127.0.0.1:{self.port}")
        headers.update(sign_request(
            self.kid, self.secret, "garage", method, path, list(query),
            headers, body, path_is_raw=True,
        ))
        # wire query must equal the signed canonical encoding (values
        # like continuation tokens carry '=' and '+')
        qs = "&".join(f"{uri_encode(k)}={uri_encode(v)}" for k, v in query)
        url = yarl.URL(
            f"http://127.0.0.1:{self.port}{path}" + (f"?{qs}" if qs else ""),
            encoded=True)
        async with self.session.request(
            method, url, data=body, headers=headers,
        ) as r:
            rb = await r.read()
            if r.status == 503 and self.honor_retry_after:
                try:
                    ra = float(r.headers.get("Retry-After", 1))
                except (TypeError, ValueError):
                    ra = 1.0
                self._backoff_until = time.monotonic() + min(
                    max(ra, 0.0), self.retry_after_cap)
            return r.status, rb, r.headers
