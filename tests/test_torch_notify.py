"""PyTorch port, slice 11: utils/notify.py against the JAX package's.

`send_dict` does nothing without credentials and sends the JAX package's
message through SMTP over SSL with them (smtplib.SMTP_SSL monkeypatched:
no network); `log_results` appends the JAX package's JSONL record, byte
for byte at the same clock.
"""

import json

import pytest

jax = pytest.importorskip("jax")

from nerfail_tpu.utils import notify as jnotify  # noqa: E402
from nerfail_tpu_torch.utils import notify  # noqa: E402

CREDS = dict(smtp_host="smtp.example", smtp_user="me@example",
             smtp_password="pw", to_addr="you@example")


def test_send_dict_is_off_without_credentials():
    assert notify.send_dict("s", {"asr": 1.0}) is False
    for drop in CREDS:
        partial = {k: v for k, v in CREDS.items() if k != drop}
        assert notify.send_dict("s", {"asr": 1.0}, **partial) is False


def test_send_dict_sends_with_credentials(monkeypatch):
    import smtplib

    sent = []

    class FakeSMTP:
        def __init__(self, host):
            sent.append(("host", host))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            sent.append(("closed",))
            return False

        def login(self, user, password):
            sent.append(("login", user, password))

        def sendmail(self, frm, to, msg):
            sent.append(("sendmail", frm, tuple(to), msg))

    monkeypatch.setattr(smtplib, "SMTP_SSL", FakeSMTP)
    results = {"asr": 0.875, "psnr": 31.5}
    assert notify.send_dict("NeRFail lego", results, **CREDS) is True
    ours = list(sent)
    sent.clear()
    assert jnotify.send_dict("NeRFail lego", results, **CREDS) is True
    assert [e[:3] for e in ours] == [e[:3] for e in sent]
    assert ours[0] == ("host", "smtp.example")
    assert ours[1] == ("login", "me@example", "pw")
    body = ours[2][3]
    assert "Subject: NeRFail lego" in body and "To: you@example" in body
    assert "<td>asr</td><td>0.875</td>" in body
    assert ours[-1] == ("closed",)


def test_log_results_appends_the_jax_record(tmp_path, monkeypatch):
    import time

    monkeypatch.setattr(time, "time", lambda: 1234.5)
    ours, theirs = tmp_path / "a" / "log.jsonl", tmp_path / "b" / "log.jsonl"
    for rec in ({"asr": 1.0}, {"psnr": 30.25, "n": 3}):
        notify.log_results(str(ours), "run", rec)
        jnotify.log_results(str(theirs), "run", rec)
    assert ours.read_text() == theirs.read_text()
    lines = [json.loads(x) for x in ours.read_text().splitlines()]
    assert lines == [{"time": 1234.5, "tag": "run", "asr": 1.0},
                     {"time": 1234.5, "tag": "run", "psnr": 30.25, "n": 3}]
