"""Version check against PyPI with snooze/skip persistence
(picasso_tpu/updater.py; picasso/updater.py get_latest_version :27,
check_and_notify :138). The port is shipped in the picasso-tpu
distribution, whose version it compares with. Network failures are
swallowed: offline machines skip the check. Host code."""

from __future__ import annotations

import datetime
import json
import urllib.request

from picasso_torch import __version__, io

_PYPI_URL = "https://pypi.org/pypi/picasso-tpu/json"
_SNOOZE_DAYS = 7

URL_GITHUB_REPO = "https://github.com/jungmannlab/picasso"
URL_LATEST_RELEASE = URL_GITHUB_REPO + "/releases/latest"
URL_LATEST_RELEASE_API = (
    "https://api.github.com/repos/jungmannlab/picasso/releases/latest")


def get_latest_version(timeout: float = 3.0) -> str | None:
    """Latest released version on PyPI, or None if unreachable
    (picasso/updater.py:27)."""
    try:
        with urllib.request.urlopen(_PYPI_URL, timeout=timeout) as r:
            data = json.load(r)
        return data["info"]["version"]
    except Exception:
        return None


def _parse_version(v: str) -> tuple[int, ...]:
    parts = []
    for p in v.split("."):
        digits = "".join(c for c in p if c.isdigit())
        parts.append(int(digits) if digits else 0)
    return tuple(parts)


def _today() -> str:
    return datetime.date.today().isoformat()


def _set(key: str, value) -> None:
    settings = io.load_user_settings()
    settings["Updater"][key] = value
    io.save_user_settings(settings)


def check_for_update() -> str | None:
    """The newer version string if one exists, else None."""
    latest = get_latest_version()
    if latest is None:
        return None
    if _parse_version(latest) > _parse_version(__version__):
        return latest
    return None


def check_and_notify(notify=print) -> str | None:
    """Check for updates under the user's snooze/skip settings in
    ~/.picasso/settings.yaml (picasso/updater.py:138)."""
    upd = io.load_user_settings()["Updater"]
    snooze_until_ = upd.get("Snooze until")
    if snooze_until_ and _today() < str(snooze_until_):
        return None
    latest = check_for_update()
    if latest is None or upd.get("Skipped version") == latest:
        return None
    notify(f"A new version of picasso-tpu is available: {latest} "
           f"(installed: {__version__}).")
    return latest


def snooze(days: int = _SNOOZE_DAYS) -> None:
    """Silence update notifications for ``days`` days."""
    until = datetime.date.today() + datetime.timedelta(days=days)
    _set("Snooze until", until.isoformat())


def skip_version(version: str) -> None:
    """Never notify about this version again."""
    _set("Skipped version", version)


def is_update_available() -> bool:
    return check_for_update() is not None


def get_update_url() -> str:
    return URL_LATEST_RELEASE


def should_check_today() -> bool:
    """True unless a check was recorded today or updates are snoozed or
    disabled."""
    upd = io.load_user_settings()["Updater"]
    if upd.get("Disabled"):
        return False
    today = _today()
    if upd.get("Last checked") == today:
        return False
    snooze_until_ = upd.get("Snooze until")
    return not (snooze_until_ and today < str(snooze_until_))


def mark_checked() -> None:
    _set("Last checked", _today())


def should_notify(version: str) -> bool:
    return io.load_user_settings()["Updater"].get("Skipped version") != version


def snooze_until(date_iso: str) -> None:
    _set("Snooze until", date_iso)


def disable_updates(disabled: bool = True) -> None:
    _set("Disabled", bool(disabled))


def cli_notify_update() -> None:
    """Console entry: check and print a notice if an update exists."""
    if should_check_today():
        check_and_notify(print)
        mark_checked()


def setup_gui_update_check(*args, **kwargs) -> None:
    """The reference's Qt hook; the port has no Qt, so this is the
    console check."""
    cli_notify_update()
