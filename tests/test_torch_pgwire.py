"""The port's pgwire server against the JAX package's, over real TCP.

Each case of tests/test_pgwire.py runs against both servers (the JAX
Session and the port's `Session(device="cpu")`, each over the employees and
departments CSVs) with the reference's own assertions, and the raw messages
the two servers send for the same SELECTs (RowDescription, every DataRow,
CommandComplete, ReadyForQuery) must be byte for byte equal: a DATE, a
DECIMAL, a LIST (ARRAY_AGG), NULLs, floats and strings among them. SCRAM,
MD5 and TLS handshakes run against both; TLS skips without openssl, as the
reference's test does.
"""

import concurrent.futures
import os
import shutil
import socket
import ssl
import struct
import subprocess

import pytest

from query_engine_tpu.engine.session import Session as JSession
from query_engine_tpu.pgwire import auth as jauth
from query_engine_tpu.pgwire import server as jserver
from query_engine_tpu.pgwire import tls as jtls
from query_engine_tpu_torch.engine.session import Session as TSession
from query_engine_tpu_torch.pgwire import auth as tauth
from query_engine_tpu_torch.pgwire import server as tserver
from query_engine_tpu_torch.pgwire import tls as ttls

from pg_client import PgTestClient
from torch_pg_wire import ServerThread, WireClient

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data")
PKGS = ("jax", "torch")
MODS = {"jax": (JSession, jserver, jauth, jtls),
        "torch": (lambda: TSession(device="cpu"), tserver, tauth, ttls)}


def make_server(pkg, auth=None, tls=None):
    session_cls, server, _, _ = MODS[pkg]
    s = session_cls()
    s.register_csv("employees", os.path.join(DATA, "employees.csv"))
    s.register_csv("departments", os.path.join(DATA, "departments.csv"))
    return server.PgServer(s, host="127.0.0.1", port=0, auth=auth, tls=tls)


@pytest.fixture(scope="module")
def servers():
    threads = {pkg: ServerThread(make_server(pkg)).start() for pkg in PKGS}
    yield threads
    for t in threads.values():
        t.stop()


@pytest.fixture(params=PKGS)
def pkg(request):
    return request.param


@pytest.fixture()
def server(servers, pkg):
    return servers[pkg]


@pytest.fixture()
def client(server):
    c = PgTestClient("127.0.0.1", server.port)
    yield c
    c.close()


@pytest.mark.parametrize("mod", [jserver, tserver], ids=PKGS)
def test_split_statements(mod):
    assert mod.split_statements("SELECT 1; SELECT ';'; SELECT 2") == [
        "SELECT 1", "SELECT ';'", "SELECT 2",
    ]


def test_simple_select(client):
    cols, rows, tags = client.query(
        "SELECT name, age FROM employees WHERE age > 25 ORDER BY id"
    )
    assert cols == ["name", "age"]
    assert rows == [
        ("Bob", "30"), ("Charlie", "35"), ("Diana", "28"),
        ("Eve", "32"), ("Frank", "29"),
    ]
    assert tags == ["SELECT 5"]


def test_join_and_null_encoding(client):
    cols, rows, _ = client.query(
        "SELECT e.name, d.dept_name FROM employees e "
        "LEFT JOIN departments d ON e.dept_id = d.dept_id ORDER BY e.id"
    )
    assert rows[-1] == ("Frank", None)


def test_multi_statement_and_tx_tags(client):
    _, _, tags = client.query("BEGIN; SELECT 1; COMMIT")
    assert tags == ["BEGIN", "SELECT 1", "COMMIT"]


def test_transaction_rollback_over_the_wire(client):
    client.query("CREATE TABLE txw (a INT)")
    try:
        client.query("BEGIN")
        assert client.last_txn_status == b"T"
        client.query("INSERT INTO txw VALUES (1)")
        _, rows, _ = client.query("SELECT COUNT(*) FROM txw")
        assert rows == [("1",)]
        # a failed statement flips ReadyForQuery to E until ROLLBACK
        with pytest.raises(RuntimeError):
            client.query("SELECT * FROM no_such_table")
        assert client.last_txn_status == b"E"
        client.query("ROLLBACK")
        assert client.last_txn_status == b"I"
        _, rows, _ = client.query("SELECT COUNT(*) FROM txw")
        assert rows == [("0",)]
    finally:
        client.query("DROP TABLE txw")


def test_show_tables_and_describe(client):
    _, rows, _ = client.query("SHOW TABLES")
    names = {r[0] for r in rows}
    assert {"employees", "departments"} <= names
    cols, rows, _ = client.query("DESCRIBE employees")
    assert cols == ["column_name", "data_type", "nullable"]
    assert ("name", "text", "YES") in rows


def test_catalog_queries(client):
    _, rows, _ = client.query("SELECT version()")
    assert "PostgreSQL" in rows[0][0]
    _, rows, _ = client.query(
        "SELECT * FROM information_schema.columns WHERE table_name = 'employees'"
    )
    assert any(r[2] == "salary" for r in rows)


def test_ddl_dml_roundtrip(client):
    _, _, tags = client.query("CREATE TABLE pets (id INT, name TEXT)")
    assert tags == ["CREATE TABLE"]
    _, _, tags = client.query(
        "INSERT INTO pets (id, name) VALUES (1, 'rex'), (2, 'milo')"
    )
    assert tags == ["INSERT 0 2"]
    _, rows, _ = client.query("SELECT name FROM pets ORDER BY id")
    assert rows == [("rex",), ("milo",)]
    _, _, tags = client.query("UPDATE pets SET name = 'max' WHERE id = 1")
    assert tags == ["UPDATE 1"]
    _, _, tags = client.query("DELETE FROM pets WHERE id = 2")
    assert tags == ["DELETE 1"]


def test_error_response(client):
    with pytest.raises(RuntimeError, match="not found"):
        client.query("SELECT * FROM no_such_table")
    # connection still usable after error
    _, rows, _ = client.query("SELECT 1")
    assert rows == [("1",)]


def test_cursors(client):
    client.query("DECLARE c1 CURSOR FOR SELECT id FROM employees ORDER BY id")
    _, rows, tags = client.query("FETCH 2 FROM c1")
    assert rows == [("1",), ("2",)] and tags == ["FETCH 2"]
    _, rows, _ = client.query("FETCH ALL FROM c1")
    assert [r[0] for r in rows] == ["3", "4", "5", "6"]
    _, _, tags = client.query("CLOSE c1")
    assert tags == ["CLOSE CURSOR"]


def test_copy_in_and_out(client):
    client.query("CREATE TABLE cp (id INT, label TEXT)")
    tag = client.copy_in("COPY cp FROM STDIN", ["1\talpha", "2\t\\N"])
    assert tag == "COPY 2"
    _, rows, _ = client.query("SELECT id, label FROM cp ORDER BY id")
    assert rows == [("1", "alpha"), ("2", None)]


def test_extended_protocol_params(client):
    cols, rows, tags = client.prepared(
        "SELECT name FROM employees WHERE age > $1 ORDER BY id", ["30"]
    )
    assert cols == ["name"]
    assert rows == [("Charlie",), ("Eve",)]
    assert tags[-1].startswith("SELECT")


def test_md5_auth(pkg):
    s = ServerThread(make_server(
        pkg, auth=MODS[pkg][2].AuthConfig.md5({"admin": "secret"}))).start()
    try:
        c = PgTestClient("127.0.0.1", s.port, user="admin", password="secret")
        _, rows, _ = c.query("SELECT 1")
        assert rows == [("1",)]
        c.close()
        with pytest.raises(Exception):
            PgTestClient("127.0.0.1", s.port, user="admin", password="wrong")
    finally:
        s.stop()


def test_tls_connection(pkg, tmp_path):
    if shutil.which("openssl") is None:
        pytest.skip("no openssl")
    cert = tmp_path / "cert.pem"
    key = tmp_path / "key.pem"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", str(key), "-out", str(cert), "-days", "1",
         "-subj", "/CN=localhost"],
        check=True, capture_output=True,
    )
    s = ServerThread(make_server(
        pkg, tls=MODS[pkg][3].TlsConfig(str(cert), str(key)))).start()
    try:
        # raw socket: send SSLRequest, expect 'S', upgrade, then run a query
        sock = socket.create_connection(("127.0.0.1", s.port), timeout=5)
        sock.sendall(struct.pack("!II", 8, 80877103))
        assert sock.recv(1) == b"S"
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
        tls_sock = ctx.wrap_socket(sock)
        c = PgTestClient.__new__(PgTestClient)
        c.sock = tls_sock
        c.user = "qe"
        c.password = ""
        c._startup("qe")
        _, rows, _ = c.query("SELECT COUNT(*) FROM employees")
        assert rows == [("6",)]
        c.close()
    finally:
        s.stop()


def test_scram_sha256_auth(pkg):
    a = MODS[pkg][2]
    s = ServerThread(make_server(pkg, auth=a.AuthConfig(
        a.AuthMethod.SCRAM_SHA_256, {"alice": "s3cret"}))).start()
    try:
        c = PgTestClient("127.0.0.1", s.port, user="alice", password="s3cret")
        _, rows, _ = c.query("SELECT 21 * 2")
        assert rows == [("42",)]
        c.close()
        with pytest.raises(Exception):
            PgTestClient("127.0.0.1", s.port, user="alice", password="nope")
        with pytest.raises(Exception):
            PgTestClient("127.0.0.1", s.port, user="mallory", password="x")
    finally:
        s.stop()


def test_concurrent_clients(server):
    def worker(i):
        c = PgTestClient("127.0.0.1", server.port)
        try:
            for _ in range(5):
                _, rows, _ = c.query(
                    "SELECT COUNT(*), SUM(salary) FROM employees WHERE age > 25"
                )
                assert rows == [("5", "428000")]
            return i
        finally:
            c.close()

    with concurrent.futures.ThreadPoolExecutor(max_workers=6) as pool:
        results = list(pool.map(worker, range(6)))
    assert results == list(range(6))


def test_pgwire_explain_analyze(client):
    """EXPLAIN [ANALYZE] through the wire protocol returns plan rows."""
    cols, rows, _ = client.query(
        "EXPLAIN SELECT name FROM employees WHERE age > 25"
    )
    assert cols == ["QUERY PLAN"]
    text = "\n".join(r[0] for r in rows)
    assert "Filter" in text and "TableScan" in text
    _, rows, _ = client.query(
        "EXPLAIN ANALYZE SELECT COUNT(*) FROM employees"
    )
    text = "\n".join(r[0] for r in rows)
    assert "rows: 1" in text and "timing:" in text


# ---- the same SELECTs give the same bytes --------------------------------
SAME_BYTES = [
    "SELECT name, age FROM employees WHERE age > 25 ORDER BY id",
    # NULLs: Frank's dept_id, and the LEFT join's missing department
    "SELECT e.name, e.dept_id, d.dept_name FROM employees e "
    "LEFT JOIN departments d ON e.dept_id = d.dept_id ORDER BY e.id",
    # floats
    "SELECT dept_id, AVG(salary) AS a, SUM(salary * 1.5) AS s, "
    "MIN(age / 7.0) AS m FROM employees GROUP BY dept_id ORDER BY dept_id",
    # a DATE column and date arithmetic
    "SELECT id, DATE '2024-02-27' + id AS d FROM employees ORDER BY id",
    # a DECIMAL column
    "SELECT id, CAST(salary AS DECIMAL(12, 2)) / 3 AS dec FROM employees "
    "ORDER BY id",
    # a LIST column (ARRAY_AGG), strings quoted inside the array text
    "SELECT dept_id, ARRAY_AGG(name ORDER BY name) AS names FROM employees "
    "GROUP BY dept_id ORDER BY dept_id",
    "SELECT COUNT(*), SUM(salary), MAX(name), MIN(age) FROM employees",
    "SELECT 21 * 2, 'x' || 'y', 1.0 / 3, NULL",
    "SHOW TABLES",
    "DESCRIBE departments",
    "SELECT * FROM information_schema.columns WHERE table_name = 'employees'",
]


@pytest.mark.parametrize("sql", SAME_BYTES)
def test_same_bytes_on_the_wire(servers, sql):
    got = {}
    for pkg in PKGS:
        c = WireClient("127.0.0.1", servers[pkg].port)
        try:
            got[pkg] = c.query_raw(sql)
        finally:
            c.close()
    assert [t for t, _ in got["torch"]] == [t for t, _ in got["jax"]]
    assert any(t == b"D" for t, _ in got["jax"]), got["jax"]
    assert got["torch"] == got["jax"]


def test_extended_protocol_same_bytes(servers):
    """Parse once, Describe the statement, Bind/Execute twice: the same
    messages from both servers, ParameterDescription and RowDescription
    included."""
    got = {}
    for pkg in PKGS:
        c = WireClient("127.0.0.1", servers[pkg].port)
        try:
            c.parse("s1", "SELECT id, name, salary * 1.5 FROM employees "
                    "WHERE age > $1 AND dept_id = $2 ORDER BY id", [20, 20])
            c.describe("S", "s1")
            msgs = c.sync()
            for params in (["25", "101"], ["20", "102"]):
                c.bind("s1", params)
                c.execute()
                msgs += c.sync()
            got[pkg] = msgs
        finally:
            c.close()
    tags = [t for t, _ in got["jax"]]
    assert b"t" in tags and b"T" in tags and tags.count(b"D") == 3, tags
    assert got["torch"] == got["jax"]


def test_every_session_call_holds_the_lock():
    """The port's server makes every Session call under the Session's lock:
    the JAX server's unlocked DECLARE query, COPY TO's SELECT and COPY
    FROM's INSERT included, and the extended protocol's Describe and
    Execute. A thread that captures CUDA graphs on the same Session can
    then not run beside a request."""
    srv = make_server("torch")
    lock, sess = srv.session.lock, srv.session
    unlocked = []

    def watch(obj, name):
        real = getattr(obj, name)

        def checked(*args, **kwargs):
            if not lock._is_owned():
                unlocked.append(name)
            return real(*args, **kwargs)

        setattr(obj, name, checked)

    for name in ("sql", "execute_statement", "table_schema", "tables",
                 "views", "in_transaction", "transaction_failed"):
        watch(sess, name)
    watch(sess.planner, "create_logical_plan")
    t = ServerThread(srv).start()
    try:
        c = WireClient("127.0.0.1", t.port)
        c.query("DECLARE c1 CURSOR FOR SELECT id FROM employees ORDER BY id")
        c.query("FETCH 2 FROM c1")
        c.query("CREATE TABLE cp (id INT, label TEXT)")
        assert c.copy_in("COPY cp FROM STDIN", ["1\talpha"]) == "COPY 1"
        assert c.copy_out("COPY cp TO STDOUT") == (["1\talpha"], "COPY 1")
        c.query("SHOW TABLES; DESCRIBE employees; BEGIN; ROLLBACK")
        c.query("SELECT * FROM information_schema.tables")
        c.prepared("SELECT name FROM employees WHERE age > $1", ["30"])
        c.close()
    finally:
        t.stop()
    assert not unlocked, sorted(set(unlocked))
