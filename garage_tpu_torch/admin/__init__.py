"""Admin RPC — server-side handler for CLI commands.

Equivalent of reference src/garage/admin/mod.rs (SURVEY.md §2.9): a netapp
endpoint handling bucket/key/layout/worker/repair/stats operations from
the CLI client (which connects with a temporary keypair + the rpc secret,
main.rs:194-263).
"""

from .handler import AdminRpcHandler

__all__ = ["AdminRpcHandler"]
