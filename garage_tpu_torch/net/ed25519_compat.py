"""ed25519 import shim — the `cryptography` wheel when present, a ctypes
libsodium fallback when not.

The RPC handshake (netapp.py) needs exactly four ed25519 operations:
keygen, raw (de)serialization, sign, verify.  Containers this repo grows
in do not always ship the `cryptography` wheel (and installing one is
off-limits), but libsodium is part of the base image — so the fallback
binds `crypto_sign_{seed_keypair,detached,verify_detached}` directly and
exposes the same class surface netapp.py already uses.  Raw private
bytes are the 32-byte seed in both backends, so node_key files written
by one backend load under the other.
"""

from __future__ import annotations

try:
    from cryptography.exceptions import InvalidSignature  # noqa: F401
    from cryptography.hazmat.primitives import serialization  # noqa: F401
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (  # noqa: F401
        Ed25519PrivateKey,
        Ed25519PublicKey,
    )

    HAVE_CRYPTOGRAPHY = True
except ImportError:
    import ctypes
    import ctypes.util
    import os
    import types

    HAVE_CRYPTOGRAPHY = False

    _lib = None
    _path = ctypes.util.find_library("sodium")
    for _cand in ([_path] if _path else []) + [
        "libsodium.so.23", "libsodium.so.26", "libsodium.so",
        "libsodium.dylib",
    ]:
        try:
            _lib = ctypes.CDLL(_cand)
            break
        except OSError:
            continue
    if _lib is None:
        raise ImportError(
            "ed25519 unavailable: neither the 'cryptography' wheel nor "
            "libsodium is present in this environment"
        )
    if _lib.sodium_init() < 0:
        raise ImportError("libsodium failed to initialize")

    class InvalidSignature(Exception):
        pass

    class _Raw:
        Raw = "raw"

    class _NoEncryption:
        pass

    # just enough of cryptography.hazmat.primitives.serialization for
    # netapp's raw-bytes round trips
    serialization = types.SimpleNamespace(
        Encoding=_Raw, PrivateFormat=_Raw, PublicFormat=_Raw,
        NoEncryption=_NoEncryption,
    )

    class Ed25519PublicKey:
        __slots__ = ("_raw",)

        def __init__(self, raw: bytes):
            if len(raw) != 32:
                raise ValueError("ed25519 public key must be 32 bytes")
            self._raw = bytes(raw)

        @classmethod
        def from_public_bytes(cls, raw: bytes) -> "Ed25519PublicKey":
            return cls(raw)

        def public_bytes(self, *_a) -> bytes:
            return self._raw

        def verify(self, signature: bytes, message: bytes) -> None:
            rc = _lib.crypto_sign_verify_detached(
                bytes(signature), bytes(message),
                ctypes.c_ulonglong(len(message)), self._raw,
            )
            if rc != 0:
                raise InvalidSignature("ed25519 signature mismatch")

    class Ed25519PrivateKey:
        __slots__ = ("_seed", "_pk", "_sk")

        def __init__(self, seed: bytes):
            if len(seed) != 32:
                raise ValueError("ed25519 private key must be 32 bytes")
            self._seed = bytes(seed)
            pk = ctypes.create_string_buffer(32)
            sk = ctypes.create_string_buffer(64)
            _lib.crypto_sign_seed_keypair(pk, sk, self._seed)
            self._pk = pk.raw
            self._sk = sk.raw

        @classmethod
        def generate(cls) -> "Ed25519PrivateKey":
            return cls(os.urandom(32))

        @classmethod
        def from_private_bytes(cls, raw: bytes) -> "Ed25519PrivateKey":
            return cls(bytes(raw))

        def public_key(self) -> Ed25519PublicKey:
            return Ed25519PublicKey(self._pk)

        def private_bytes(self, *_a) -> bytes:
            return self._seed

        def sign(self, message: bytes) -> bytes:
            sig = ctypes.create_string_buffer(64)
            siglen = ctypes.c_ulonglong(0)
            _lib.crypto_sign_detached(
                sig, ctypes.byref(siglen), bytes(message),
                ctypes.c_ulonglong(len(message)), self._sk,
            )
            return sig.raw
