"""KubeAPICluster kubeconfig TLS against a live mTLS apiserver stand-in.

The reference's import/sync/record sources authenticate through
client-go's kubeconfig machinery (cluster CA, client certificates,
insecure-skip-tls-verify — simulator/docs/import-cluster-resources.md);
here the same kubeconfig fields drive a real TLS handshake: an HTTPS
server requiring client certificates serves /api/v1/nodes, and
cluster/kubeapi.load_kubeconfig must produce an SSL context that (a)
verifies the server against inline CA data, (b) presents the inline
client cert/key, and (c) never leaves the decoded key material on disk.

The port's mirror of tests/test_kubeapi_tls.py: the same cases against the
port's modules (kube_scheduler_simulator_tpu_torch), every engine and
CLI on the CPU (device="cpu", --device cpu).
"""

from __future__ import annotations

import base64
import http.server
import json
import ssl
import tempfile
import threading

import pytest

try:
    from test_extender_tls import _make_cert, _pem_cert, _pem_key
except ImportError:  # pragma: no cover
    pytest.skip("cryptography unavailable", allow_module_level=True)

from kube_scheduler_simulator_tpu_torch.cluster.kubeapi import KubeAPICluster


def _b64(b: bytes) -> str:
    return base64.b64encode(b).decode()


class _APIServer(http.server.BaseHTTPRequestHandler):
    def do_GET(self):
        body = json.dumps({
            "kind": "NodeList", "apiVersion": "v1",
            "metadata": {"resourceVersion": "77"},
            "items": [{"metadata": {"name": "tls-node",
                                    "resourceVersion": "42"}}],
        }).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


@pytest.fixture(scope="module")
def mtls_server(tmp_path_factory):
    d = tmp_path_factory.mktemp("kubeapi-pki")
    ca_key, ca_cert = _make_cert("kube-ca", is_ca=True)
    srv_key, srv_cert = _make_cert("kubeapi.test", ca_key, ca_cert,
                                   san_dns=("localhost",),
                                   san_ip=("127.0.0.1",))
    cli_key, cli_cert = _make_cert("kube-client", ca_key, ca_cert)
    paths = {}
    for name, data in (("ca.pem", _pem_cert(ca_cert)),
                       ("server.pem", _pem_cert(srv_cert)),
                       ("server.key", _pem_key(srv_key))):
        (d / name).write_bytes(data)
        paths[name] = str(d / name)

    sslctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    sslctx.load_cert_chain(paths["server.pem"], paths["server.key"])
    sslctx.load_verify_locations(paths["ca.pem"])
    sslctx.verify_mode = ssl.CERT_REQUIRED  # mTLS: client cert mandatory

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _APIServer)
    httpd.socket = sslctx.wrap_socket(httpd.socket, server_side=True)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield {
        "url": f"https://127.0.0.1:{httpd.server_address[1]}",
        "ca": _pem_cert(ca_cert),
        "client_cert": _pem_cert(cli_cert),
        "client_key": _pem_key(cli_key),
    }
    httpd.shutdown()
    httpd.server_close()


def _kubeconfig(tmp_path, server, **user):
    kc = {
        "current-context": "t",
        "contexts": [{"name": "t", "context": {"cluster": "c", "user": "u"}}],
        "clusters": [{"name": "c", "cluster": server}],
        "users": [{"name": "u", "user": user}],
    }
    p = tmp_path / "kubeconfig.yaml"
    p.write_text(json.dumps(kc))
    return str(p)


def test_mtls_roundtrip_with_inline_data(mtls_server, tmp_path, monkeypatch):
    kc = _kubeconfig(
        tmp_path,
        {"server": mtls_server["url"],
         "certificate-authority-data": _b64(mtls_server["ca"])},
        **{"client-certificate-data": _b64(mtls_server["client_cert"]),
           "client-key-data": _b64(mtls_server["client_key"])},
    )
    # private tempdir: the no-key-material-left-behind assertion must not
    # race other processes' /tmp churn
    leakdir = tmp_path / "leakcheck"
    leakdir.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(leakdir))
    c = KubeAPICluster(kubeconfig=kc)
    # a full verified+client-authenticated list over the wire
    items, rv = c.list("nodes")
    assert [o["metadata"]["name"] for o in items] == ["tls-node"]
    assert rv == 77
    # inline cert/key temp files were unlinked as soon as ssl loaded them
    assert list(leakdir.iterdir()) == []


def test_mtls_rejects_client_without_cert(mtls_server, tmp_path):
    kc = _kubeconfig(
        tmp_path,
        {"server": mtls_server["url"],
         "certificate-authority-data": _b64(mtls_server["ca"])},
    )
    c = KubeAPICluster(kubeconfig=kc)
    with pytest.raises(OSError):  # TLS alert: certificate required
        c.list("nodes")


def test_server_cert_rejected_without_ca(mtls_server, tmp_path):
    kc = _kubeconfig(
        tmp_path,
        {"server": mtls_server["url"]},  # default trust store: unknown CA
        **{"client-certificate-data": _b64(mtls_server["client_cert"]),
           "client-key-data": _b64(mtls_server["client_key"])},
    )
    c = KubeAPICluster(kubeconfig=kc)
    with pytest.raises(OSError):
        c.list("nodes")


def test_insecure_skip_verify_accepts_unknown_ca(mtls_server, tmp_path):
    kc = _kubeconfig(
        tmp_path,
        {"server": mtls_server["url"], "insecure-skip-tls-verify": True},
        **{"client-certificate-data": _b64(mtls_server["client_cert"]),
           "client-key-data": _b64(mtls_server["client_key"])},
    )
    c = KubeAPICluster(kubeconfig=kc)
    items, _ = c.list("nodes")
    assert items[0]["metadata"]["name"] == "tls-node"
