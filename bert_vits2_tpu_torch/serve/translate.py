"""Baidu translate API client (reference: tools/translate.py:12-61).

Pure stdlib (urllib + hashlib MD5 signature per the Baidu fanyi v1 docs).
Network-dependent: returns an explanatory string when keys are missing and
raises URLError offline, exactly where the reference would.
"""

from __future__ import annotations

import hashlib
import json
import random
import urllib.parse
import urllib.request

_URL = "https://fanyi-api.baidu.com/api/trans/vip/translate"


def translate(
    sentence: str,
    to_language: str = "jp",
    from_language: str = "",
    app_key: str = "",
    secret_key: str = "",
    timeout: float = 10.0,
) -> str:
    """Translate line by line; language codes per Baidu (zh/en/jp)."""
    if not app_key or not secret_key:
        return "请开发者在config.yml中配置app_key与secret_key"
    out = []
    for line in sentence.splitlines():
        if not line:
            continue
        salt = str(random.randint(32768, 65536))
        sign = hashlib.md5(
            (app_key + line + salt + secret_key).encode("utf-8")
        ).hexdigest()
        params = urllib.parse.urlencode(
            {
                "appid": app_key,
                "q": line,
                "from": from_language or "auto",
                "to": to_language,
                "salt": salt,
                "sign": sign,
            }
        )
        with urllib.request.urlopen(
            f"{_URL}?{params}", timeout=timeout
        ) as resp:
            data = json.loads(resp.read().decode("utf-8"))
        for row in data.get("trans_result", []):
            out.append(row.get("dst", ""))
    return "\n".join(out)
