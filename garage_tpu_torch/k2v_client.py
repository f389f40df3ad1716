"""K2V client library.

Equivalent of reference src/k2v-client/ (SURVEY.md §2.10, 1398 LoC): a
standalone async client for the K2V HTTP API with SigV4 signing — item
CRUD with causality tokens, long-poll, index reads and batch operations.

Usage::

    c = K2VClient("http://127.0.0.1:3904", "mybucket", key_id, secret)
    ct = await c.insert_item("pk", "sk", b"value")
    value, ct = await c.read_item("pk", "sk")
"""

from __future__ import annotations

import base64
import json
import urllib.parse
from typing import Any, Dict, List, Optional, Tuple

import aiohttp

from .api.signature import sign_request, uri_encode

CAUSALITY_HEADER = "X-Garage-Causality-Token"


class K2VError(Exception):
    def __init__(self, status: int, body: str):
        super().__init__(f"K2V error {status}: {body[:200]}")
        self.status = status


class CausalityToken(str):
    """Opaque causality token (base64 vector clock)."""


class K2VItemValue:
    """One read result: list of concurrent values (None = tombstone
    sibling) + the causality token covering them."""

    def __init__(self, values: List[Optional[bytes]], token: CausalityToken):
        self.values = values
        self.token = token

    @property
    def value(self) -> Optional[bytes]:
        live = [v for v in self.values if v is not None]
        return live[0] if len(live) == 1 and len(self.values) == 1 else None

    def __repr__(self):  # pragma: no cover
        return f"K2VItemValue({len(self.values)} values)"


class K2VClient:
    def __init__(self, endpoint: str, bucket: str, key_id: str, secret: str,
                 region: str = "garage"):
        self.endpoint = endpoint.rstrip("/")
        self.bucket = bucket
        self.key_id = key_id
        self.secret = secret
        self.region = region

    async def _req(self, method: str, path: str, query=None, body: bytes = b"",
                   headers=None, timeout: float = 60.0):
        query = query or []
        headers = {k.lower(): v for k, v in (headers or {}).items()}
        host = self.endpoint[self.endpoint.index("://") + 3:]
        headers["host"] = host
        # `path` is already the wire form (built with quote()); sign it
        # verbatim — the server verifies against the raw wire path, and
        # unquote→re-encode round-trips differently for keys with literal %2F
        sig = sign_request(
            self.key_id, self.secret, self.region, method,
            path, query, headers, body, path_is_raw=True,
        )
        headers.update(sig)
        # wire form must equal the signed canonical form (uri_encode, not
        # urlencode's '+'-for-space), now that the server signs raw pairs;
        # encoded=True stops yarl re-normalizing what we signed
        import yarl

        qs = "&".join(f"{uri_encode(k)}={uri_encode(v)}" for k, v in query)
        url = yarl.URL(
            f"{self.endpoint}{path}" + (f"?{qs}" if qs else ""), encoded=True
        )
        async with aiohttp.ClientSession() as s:
            async with s.request(
                method, url, data=body, headers=headers,
                timeout=aiohttp.ClientTimeout(total=timeout),
            ) as r:
                return r.status, r.headers.copy(), await r.read()

    def _item_path(self, pk: str, sk: str) -> str:
        return (
            f"/{urllib.parse.quote(self.bucket, safe='')}"
            f"/{urllib.parse.quote(pk, safe='')}"
            f"/{urllib.parse.quote(sk, safe='')}"
        )

    # --- item ops ---

    async def read_item(self, pk: str, sk: str) -> Optional[K2VItemValue]:
        st, hdrs, body = await self._req(
            "GET", self._item_path(pk, sk),
            headers={"accept": "application/json"},
        )
        if st == 404:
            return None
        if st != 200:
            raise K2VError(st, body.decode(errors="replace"))
        vals = [
            base64.b64decode(v) if v is not None else None
            for v in json.loads(body)
        ]
        return K2VItemValue(vals, CausalityToken(hdrs.get(CAUSALITY_HEADER, "")))

    async def insert_item(self, pk: str, sk: str, value: bytes,
                          token: Optional[str] = None) -> None:
        headers = {}
        if token:
            headers[CAUSALITY_HEADER] = str(token)
        st, _h, body = await self._req(
            "PUT", self._item_path(pk, sk), body=value, headers=headers
        )
        if st not in (200, 204):
            raise K2VError(st, body.decode(errors="replace"))

    async def delete_item(self, pk: str, sk: str, token: Optional[str] = None) -> None:
        headers = {}
        if token:
            headers[CAUSALITY_HEADER] = str(token)
        st, _h, body = await self._req(
            "DELETE", self._item_path(pk, sk), headers=headers
        )
        if st not in (200, 204):
            raise K2VError(st, body.decode(errors="replace"))

    async def poll_item(self, pk: str, sk: str, token: str,
                        timeout: float = 300.0) -> Optional[K2VItemValue]:
        """Long-poll until the item changes past `token`; None on timeout."""
        st, hdrs, body = await self._req(
            "GET", self._item_path(pk, sk),
            query=[("causality_token", str(token)), ("timeout", str(timeout))],
            headers={"accept": "application/json"},
            timeout=timeout + 30.0,
        )
        if st == 304:
            return None
        if st != 200:
            raise K2VError(st, body.decode(errors="replace"))
        vals = [
            base64.b64decode(v) if v is not None else None
            for v in json.loads(body)
        ]
        return K2VItemValue(vals, CausalityToken(hdrs.get(CAUSALITY_HEADER, "")))

    # --- index + batches ---

    async def read_index(self, start: Optional[str] = None,
                         end: Optional[str] = None,
                         prefix: Optional[str] = None,
                         limit: Optional[int] = 1000) -> Dict[str, Any]:
        q = [("limit", str(limit))] if limit is not None else []
        for name, v in (("start", start), ("end", end), ("prefix", prefix)):
            if v is not None:
                q.append((name, v))
        st, _h, body = await self._req(
            "GET", f"/{urllib.parse.quote(self.bucket, safe='')}", query=q
        )
        if st != 200:
            raise K2VError(st, body.decode(errors="replace"))
        return json.loads(body)

    async def insert_batch(self, items: List[Tuple[str, str, Optional[bytes], Optional[str]]]) -> None:
        """items = [(pk, sk, value|None, causality_token|None)]."""
        payload = json.dumps([
            {
                "pk": pk, "sk": sk,
                "v": base64.b64encode(v).decode() if v is not None else None,
                "ct": str(ct) if ct else None,
            }
            for pk, sk, v, ct in items
        ]).encode()
        st, _h, body = await self._req(
            "POST", f"/{urllib.parse.quote(self.bucket, safe='')}", body=payload
        )
        if st not in (200, 204):
            raise K2VError(st, body.decode(errors="replace"))

    async def read_batch(self, queries: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        st, _h, body = await self._req(
            "POST", f"/{urllib.parse.quote(self.bucket, safe='')}",
            query=[("search", "")], body=json.dumps(queries).encode(),
        )
        if st != 200:
            raise K2VError(st, body.decode(errors="replace"))
        return json.loads(body)

    async def delete_batch(self, queries: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        st, _h, body = await self._req(
            "POST", f"/{urllib.parse.quote(self.bucket, safe='')}",
            query=[("delete", "")], body=json.dumps(queries).encode(),
        )
        if st != 200:
            raise K2VError(st, body.decode(errors="replace"))
        return json.loads(body)

    async def poll_range(self, pk: str, seen_marker: Optional[str] = None,
                         prefix: Optional[str] = None,
                         timeout: float = 300.0) -> Optional[Dict[str, Any]]:
        payload: Dict[str, Any] = {"timeout": timeout}
        if seen_marker:
            payload["seenMarker"] = seen_marker
        if prefix:
            payload["prefix"] = prefix
        st, _h, body = await self._req(
            "POST",
            f"/{urllib.parse.quote(self.bucket, safe='')}/{urllib.parse.quote(pk, safe='')}",
            query=[("poll_range", "")], body=json.dumps(payload).encode(),
            timeout=timeout + 30.0,
        )
        if st == 304:
            return None
        if st != 200:
            raise K2VError(st, body.decode(errors="replace"))
        return json.loads(body)

    # --- range convenience wrappers (ref k2v-cli ReadRange/DeleteRange:
    #     single-query ReadBatch/DeleteBatch) ---

    async def read_range(self, pk: str, start: Optional[str] = None,
                         end: Optional[str] = None,
                         prefix: Optional[str] = None,
                         limit: Optional[int] = None) -> Dict[str, Any]:
        q: Dict[str, Any] = {"partitionKey": pk}
        if start:
            q["start"] = start
        if end:
            q["end"] = end
        if prefix:
            q["prefix"] = prefix
        if limit:
            q["limit"] = limit
        return (await self.read_batch([q]))[0]

    async def delete_range(self, pk: str, start: Optional[str] = None,
                           end: Optional[str] = None,
                           prefix: Optional[str] = None) -> Dict[str, Any]:
        q: Dict[str, Any] = {"partitionKey": pk}
        if start:
            q["start"] = start
        if end:
            q["end"] = end
        if prefix:
            q["prefix"] = prefix
        # one call: the server walks the whole range internally (the
        # reference's DeleteRange contract)
        return (await self.delete_batch([q]))[0]


# --- CLI (equivalent of the reference's k2v-cli binary,
#     src/k2v-client/bin/k2v-cli.rs: Insert/Read/Delete/PollItem/
#     PollRange/ReadIndex/ReadRange/DeleteRange) ---


def _cli_parser():
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m garage_tpu_torch.k2v_client",
        description="K2V command-line client (ref k2v-cli)",
    )
    p.add_argument("--endpoint", required=True, help="http://host:port")
    p.add_argument("--bucket", required=True)
    p.add_argument("--key-id", required=True)
    p.add_argument("--secret", required=True)
    p.add_argument("--region", default="garage")
    sub = p.add_subparsers(dest="cmd", required=True)

    ins = sub.add_parser("insert")
    ins.add_argument("partition_key")
    ins.add_argument("sort_key")
    ins.add_argument("value", help="literal value, or @file, or - for stdin")
    ins.add_argument("--token", default=None, help="causality token")

    rd = sub.add_parser("read")
    rd.add_argument("partition_key")
    rd.add_argument("sort_key")

    de = sub.add_parser("delete")
    de.add_argument("partition_key")
    de.add_argument("sort_key")
    de.add_argument("--token", default=None)

    pi = sub.add_parser("poll-item")
    pi.add_argument("partition_key")
    pi.add_argument("sort_key")
    pi.add_argument("token")
    pi.add_argument("--timeout", type=float, default=300.0)

    pr = sub.add_parser("poll-range")
    pr.add_argument("partition_key")
    pr.add_argument("--seen-marker", default=None)
    pr.add_argument("--prefix", default=None)
    pr.add_argument("--timeout", type=float, default=300.0)

    ri = sub.add_parser("read-index")
    ri.add_argument("--start", default=None)
    ri.add_argument("--end", default=None)
    ri.add_argument("--limit", type=int, default=None)

    rr = sub.add_parser("read-range")
    rr.add_argument("partition_key")
    rr.add_argument("--start", default=None)
    rr.add_argument("--end", default=None)
    rr.add_argument("--prefix", default=None)
    rr.add_argument("--limit", type=int, default=None)

    dr = sub.add_parser("delete-range")
    dr.add_argument("partition_key")
    dr.add_argument("--start", default=None)
    dr.add_argument("--end", default=None)
    dr.add_argument("--prefix", default=None)
    return p


async def _cli_main(args) -> None:
    import sys

    c = K2VClient(args.endpoint, args.bucket, args.key_id, args.secret,
                  region=args.region)
    if args.cmd == "insert":
        v = args.value
        if v == "-":
            data = sys.stdin.buffer.read()
        elif v.startswith("@"):
            with open(v[1:], "rb") as f:
                data = f.read()
        else:
            data = v.encode()
        await c.insert_item(args.partition_key, args.sort_key, data,
                            token=args.token)
        print("ok")
    elif args.cmd == "read":
        item = await c.read_item(args.partition_key, args.sort_key)
        if item is None:
            print("(not found)")
            return
        print(f"causality token: {item.token}")
        for v in item.values:
            print("(tombstone)" if v is None else v.decode(errors="replace"))
    elif args.cmd == "delete":
        tok = args.token
        if tok is None:
            item = await c.read_item(args.partition_key, args.sort_key)
            if item is None:
                print("(not found)")
                return
            tok = item.token
        await c.delete_item(args.partition_key, args.sort_key, token=tok)
        print("deleted")
    elif args.cmd == "poll-item":
        item = await c.poll_item(args.partition_key, args.sort_key,
                                 args.token, timeout=args.timeout)
        if item is None:
            print("(timeout, no new value)")
        else:
            print(f"causality token: {item.token}")
            for v in item.values:
                print("(tombstone)" if v is None else
                      v.decode(errors="replace"))
    elif args.cmd == "poll-range":
        res = await c.poll_range(args.partition_key,
                                 seen_marker=args.seen_marker,
                                 prefix=args.prefix, timeout=args.timeout)
        print(json.dumps(res if res is not None
                         else {"timeout": True}, indent=2))
    elif args.cmd == "read-index":
        res = await c.read_index(start=args.start, end=args.end,
                                 limit=args.limit)
        print(json.dumps(res, indent=2))
    elif args.cmd == "read-range":
        res = await c.read_range(args.partition_key, start=args.start,
                                 end=args.end, prefix=args.prefix,
                                 limit=args.limit)
        print(json.dumps(res, indent=2))
    elif args.cmd == "delete-range":
        res = await c.delete_range(args.partition_key, start=args.start,
                                   end=args.end, prefix=args.prefix)
        print(json.dumps(res, indent=2))


if __name__ == "__main__":  # pragma: no cover — exercised via subprocess
    import asyncio as _asyncio

    _asyncio.run(_cli_main(_cli_parser().parse_args()))
