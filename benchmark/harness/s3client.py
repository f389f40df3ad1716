"""A SigV4 S3 client written from the AWS specification.

Copied from the repo's interop test client (``tests/independent_s3_client.py``),
which imports nothing of either package, and cut to what the load
generator needs: header-signed requests over one ``aiohttp`` session,
the payload's SHA-256 computed before the request is due, and no
retries, so that a refused or failed request counts as failed.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import urllib.parse

import aiohttp

EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


def _uri_encode(s: str, slash_ok: bool = False) -> str:
    safe = "-._~" + ("/" if slash_ok else "")
    return urllib.parse.quote(s, safe=safe)


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


class S3Client:
    def __init__(self, session: aiohttp.ClientSession, endpoint: str,
                 key_id: str, secret: str, region: str = "garage",
                 timeout: float = 60.0):
        self.session = session
        self.endpoint = endpoint.rstrip("/")
        self.host = endpoint.split("://", 1)[1].rstrip("/")
        self.key_id, self.secret, self.region = key_id, secret, region
        self.timeout = aiohttp.ClientTimeout(total=timeout)

    # --- SigV4 core (AWS sigv4 spec) ---

    def _scope(self, date: str) -> str:
        return f"{date}/{self.region}/s3/aws4_request"

    def _signing_key(self, date: str) -> bytes:
        k = _hmac(b"AWS4" + self.secret.encode(), date)
        k = _hmac(k, self.region)
        k = _hmac(k, "s3")
        return _hmac(k, "aws4_request")

    def _canonical(self, method, path, query, headers, payload_hash):
        cq = "&".join(f"{_uri_encode(k)}={_uri_encode(v)}"
                      for k, v in sorted(query))
        signed = ";".join(sorted(h.lower() for h in headers))
        ch = "".join(f"{h.lower()}:{headers[h].strip()}\n"
                     for h in sorted(headers, key=str.lower))
        return (f"{method}\n{_uri_encode(path, slash_ok=True)}\n{cq}\n"
                f"{ch}\n{signed}\n{payload_hash}"), signed

    def _sign(self, canonical: str, amzdate: str) -> str:
        date = amzdate[:8]
        sts = ("AWS4-HMAC-SHA256\n" + amzdate + "\n" + self._scope(date)
               + "\n" + hashlib.sha256(canonical.encode()).hexdigest())
        return hmac.new(self._signing_key(date), sts.encode(),
                        hashlib.sha256).hexdigest()

    def _auth_headers(self, method, path, query, payload_hash) -> dict:
        now = datetime.datetime.now(datetime.timezone.utc)
        amzdate = now.strftime("%Y%m%dT%H%M%SZ")
        headers = {"host": self.host, "x-amz-date": amzdate,
                   "x-amz-content-sha256": payload_hash}
        canonical, signed = self._canonical(method, path, query, headers,
                                            payload_hash)
        sig = self._sign(canonical, amzdate)
        headers["Authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={self.key_id}/"
            f"{self._scope(amzdate[:8])}, SignedHeaders={signed}, "
            f"Signature={sig}")
        return headers

    async def request(self, method: str, path: str, body=b"",
                      payload_hash: str = None, query=()) -> tuple:
        """(status, body) of one signed request."""
        if payload_hash is None:
            payload_hash = hashlib.sha256(body).hexdigest()
        hdrs = self._auth_headers(method, path, list(query), payload_hash)
        qs = "&".join(f"{_uri_encode(k)}={_uri_encode(v)}" for k, v in query)
        url = f"{self.endpoint}{_uri_encode(path, slash_ok=True)}" + (
            f"?{qs}" if qs else "")
        import yarl

        async with self.session.request(
                method, yarl.URL(url, encoded=True), data=body, headers=hdrs,
                skip_auto_headers=("Content-Type",), timeout=self.timeout) as r:
            return r.status, await r.read()
