"""Kubeconfig parsing and authenticated HTTP client construction.

The reference delegates all of this to the ``kubernetes`` client package
(`robusta_krr/core/integrations/kubernetes.py:5,29`), which is
not a dependency — so the small slice krr actually needs is
implemented directly over httpx:

* kubeconfig resolution ($KUBECONFIG → ~/.kube/config), contexts/clusters/users;
* auth: bearer token, basic auth, client certificates (inline base64 data or
  file paths), and ``exec`` credential plugins (EKS/GKE-style);
* in-cluster config from the mounted service-account token;
* TLS: cluster CA data/file or insecure-skip-verify.

Everything is lazy — nothing authenticates at import time (the reference does,
`config.py:10-15`, flagged in SURVEY.md §3.1 as a boundary hazard).
"""

from __future__ import annotations

import base64
import json
import os
import ssl
import subprocess
import tempfile
from dataclasses import dataclass, field
from typing import Any, Optional

import httpx
import yaml

SERVICE_ACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class KubeConfigError(Exception):
    pass


@dataclass
class ClusterCredentials:
    """Resolved connection info for one cluster context."""

    server: str
    context_name: Optional[str] = None
    ca_pem: Optional[str] = None
    insecure_skip_tls_verify: bool = False
    token: Optional[str] = None
    #: Path of a rotating on-disk token (kubeconfig ``tokenFile`` /
    #: service-account projected token) — re-read on refresh.
    token_file: Optional[str] = None
    username: Optional[str] = None
    password: Optional[str] = None
    client_cert_file: Optional[str] = None
    client_key_file: Optional[str] = None
    exec_spec: Optional[dict[str, Any]] = None
    _tempfiles: list[str] = field(default_factory=list, repr=False)

    def resolve_token(self) -> Optional[str]:
        """Return a bearer token, reading the token file / running the exec
        credential plugin if configured (cached until refreshed)."""
        if self.token:
            return self.token
        if self.token_file:
            with open(self.token_file) as f:
                self.token = f.read().strip()
            return self.token
        if self.exec_spec:
            self.token = _run_exec_plugin(self.exec_spec)
            return self.token
        return None

    def auth_headers(self) -> dict[str, str]:
        token = self.resolve_token()
        if token:
            return {"Authorization": f"Bearer {token}"}
        if self.username is not None and self.password is not None:
            basic = base64.b64encode(f"{self.username}:{self.password}".encode()).decode()
            return {"Authorization": f"Basic {basic}"}
        return {}

    def refresh_auth_headers(self) -> dict[str, str]:
        """Auth headers with any REFRESHABLE token re-resolved:
        ``resolve_token`` caches its result, so after a 401 mid-scan the
        cached (expired) token must be dropped and re-derived — by re-running
        the exec plugin or re-reading a rotating ``tokenFile`` (kubelet
        projects fresh tokens onto disk). A static inline kubeconfig token
        has nothing to refresh and is returned as-is — a repeat 401 with it
        is a real authz failure."""
        if self.exec_spec or self.token_file:
            self.token = None  # drop the cached (expired) token
        return self.auth_headers()

    def ssl_verify(self) -> ssl.SSLContext | bool:
        if self.insecure_skip_tls_verify:
            return False
        ctx = ssl.create_default_context(cadata=self.ca_pem) if self.ca_pem else ssl.create_default_context()
        if self.client_cert_file:
            ctx.load_cert_chain(self.client_cert_file, self.client_key_file)
        return ctx

    def make_client(
        self, timeout: float = 30.0, max_connections: Optional[int] = 32
    ) -> httpx.AsyncClient:
        """``max_connections=None`` builds an UNCAPPED pool — the watch
        client's shape: one long-lived stream per watched resource, where a
        cap would let stream count starve ordinary list requests."""
        return httpx.AsyncClient(
            base_url=self.server.rstrip("/"),
            headers=self.auth_headers(),
            verify=self.ssl_verify(),
            timeout=timeout,
            limits=httpx.Limits(max_connections=max_connections),
        )


def _run_exec_plugin(spec: dict[str, Any]) -> str:
    """Run a client-go exec credential plugin and return the token."""
    env = dict(os.environ)
    for entry in spec.get("env") or []:
        env[entry["name"]] = entry["value"]
    cmd = [spec["command"], *(spec.get("args") or [])]
    try:
        out = subprocess.run(cmd, env=env, capture_output=True, check=True, timeout=60).stdout
    except (subprocess.SubprocessError, OSError) as e:
        raise KubeConfigError(f"exec credential plugin {cmd[0]!r} failed: {e}") from e
    try:
        credential = json.loads(out)
        return credential["status"]["token"]
    except (json.JSONDecodeError, KeyError) as e:
        raise KubeConfigError(f"exec credential plugin {cmd[0]!r} returned invalid ExecCredential") from e


def _materialize(data_b64: Optional[str], path: Optional[str], holder: list[str]) -> Optional[str]:
    """Inline base64 data → temp file path; else pass the configured path through."""
    if data_b64:
        f = tempfile.NamedTemporaryFile(mode="wb", suffix=".pem", delete=False)
        f.write(base64.b64decode(data_b64))
        f.close()
        holder.append(f.name)
        return f.name
    return path


def default_kubeconfig_path() -> str:
    return os.environ.get("KUBECONFIG") or os.path.expanduser("~/.kube/config")


class KubeConfig:
    """Parsed kubeconfig with context → credential resolution."""

    def __init__(self, doc: dict[str, Any]):
        self._doc = doc
        self.clusters = {c["name"]: c["cluster"] for c in doc.get("clusters", [])}
        self.users = {u["name"]: u["user"] for u in doc.get("users", [])}
        self.contexts = {c["name"]: c["context"] for c in doc.get("contexts", [])}
        self.current_context: Optional[str] = doc.get("current-context")

    @classmethod
    def load(cls, path: Optional[str] = None) -> "KubeConfig":
        path = path or default_kubeconfig_path()
        if not os.path.exists(path):
            raise KubeConfigError(f"kubeconfig not found at {path}")
        with open(path) as f:
            return cls(yaml.safe_load(f) or {})

    def context_names(self) -> list[str]:
        return list(self.contexts)

    def credentials_for(self, context: Optional[str] = None) -> ClusterCredentials:
        name = context or self.current_context
        if name is None or name not in self.contexts:
            raise KubeConfigError(f"context {name!r} not found (have: {', '.join(self.contexts) or 'none'})")
        ctx = self.contexts[name]
        cluster = self.clusters.get(ctx["cluster"])
        user = self.users.get(ctx.get("user", ""), {})
        if cluster is None:
            raise KubeConfigError(f"cluster {ctx['cluster']!r} not found in kubeconfig")

        holder: list[str] = []
        ca_pem: Optional[str] = None
        if cluster.get("certificate-authority-data"):
            ca_pem = base64.b64decode(cluster["certificate-authority-data"]).decode()
        elif cluster.get("certificate-authority"):
            with open(cluster["certificate-authority"]) as f:
                ca_pem = f.read()

        # Inline tokens are static; a tokenFile is retained as a PATH so a
        # mid-scan refresh can re-read the rotated token (resolve_token
        # reads it lazily on first use).
        return ClusterCredentials(
            server=cluster["server"],
            context_name=name,
            ca_pem=ca_pem,
            insecure_skip_tls_verify=bool(cluster.get("insecure-skip-tls-verify")),
            token=user.get("token"),
            token_file=None if user.get("token") else user.get("tokenFile"),
            username=user.get("username"),
            password=user.get("password"),
            client_cert_file=_materialize(user.get("client-certificate-data"), user.get("client-certificate"), holder),
            client_key_file=_materialize(user.get("client-key-data"), user.get("client-key"), holder),
            exec_spec=user.get("exec"),
            _tempfiles=holder,
        )


def in_cluster_credentials() -> ClusterCredentials:
    """Credentials from the mounted service-account (when running in a pod)."""
    host = os.environ.get("KUBERNETES_SERVICE_HOST")
    port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
    token_path = os.path.join(SERVICE_ACCOUNT_DIR, "token")
    ca_path = os.path.join(SERVICE_ACCOUNT_DIR, "ca.crt")
    if not host or not os.path.exists(token_path):
        raise KubeConfigError("not running inside a cluster (no service account mounted)")
    ca_pem = None
    if os.path.exists(ca_path):
        with open(ca_path) as f:
            ca_pem = f.read()
    # Kept as a PATH: bound service-account tokens rotate on disk, and a
    # mid-scan refresh must re-read the projected file.
    return ClusterCredentials(server=f"https://{host}:{port}", token_file=token_path, ca_pem=ca_pem)


def resolve_credentials(
    context: Optional[str] = None, kubeconfig_path: Optional[str] = None
) -> ClusterCredentials:
    """In-cluster when a service account is mounted and no explicit context is
    requested; kubeconfig otherwise."""
    if context is None and kubeconfig_path is None:
        try:
            return in_cluster_credentials()
        except KubeConfigError:
            pass
    return KubeConfig.load(kubeconfig_path).credentials_for(context)
