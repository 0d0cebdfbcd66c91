"""Result notification (the reference's tools/send_e_mail.py:7-43).

Ports nerfail_tpu/utils/notify.py. `send_dict` emails an HTML table of
the results dict via SMTP and does nothing until credentials are given
(the reference ships placeholder credentials and does nothing too).
`log_results` appends a JSONL record, the channel that works offline.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


def send_dict(
    subject: str,
    results: Dict,
    smtp_host: Optional[str] = None,
    smtp_user: Optional[str] = None,
    smtp_password: Optional[str] = None,
    to_addr: Optional[str] = None,
) -> bool:
    """Email `results` as an HTML table. Returns False (no-op) until SMTP
    credentials are provided, mirroring the reference's disabled default."""
    if not (smtp_host and smtp_user and smtp_password and to_addr):
        return False
    import smtplib
    from email.mime.text import MIMEText

    rows = "".join(
        f"<tr><td>{k}</td><td>{v}</td></tr>" for k, v in results.items()
    )
    html = f"<table border='1'><tr><th>key</th><th>value</th></tr>{rows}</table>"
    msg = MIMEText(html, "html")
    msg["Subject"] = subject
    msg["From"] = smtp_user
    msg["To"] = to_addr
    with smtplib.SMTP_SSL(smtp_host) as s:
        s.login(smtp_user, smtp_password)
        s.sendmail(smtp_user, [to_addr], msg.as_string())
    return True


def log_results(path: str, tag: str, results: Dict) -> None:
    """Append a timestamped result record to a JSONL log."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps({"time": time.time(), "tag": tag, **results}) + "\n")
