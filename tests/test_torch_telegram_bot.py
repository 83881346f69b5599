"""The port's Telegram demo bot (``lenslesspicam_tpu_torch/scripts/demo_apps/
telegram_bot.py``) against the JAX package's, in-process on the CPU
(``LPT_PLATFORM=cpu``) with the dummy rig (the measurement simulated by
convolving the displayed photo with the user's PSF) and a DigiCam ``mask``
config at ``downsample=16``.

python-telegram-bot is on neither machine: ``StandInTelegram`` puts
``chip_smoke.py``'s stand-in ``telegram`` and ``telegram.ext`` modules in
``sys.modules``, whose ``ApplicationBuilder`` records the handlers instead
of polling, and each request is a fake update, its ``reply_text`` /
``reply_photo`` recorded, driven by ``asyncio.run``.  Each bot's
``make_rig`` and ``make_reconstructor`` are wrapped so that every
request's PSF, measurement and result are kept.

What is held:

- the replies, the user PSFs (the ``.npy`` within TOL_SIM of its max, the
  PNG within one level) and every reconstruction that both bots solve on
  their own PSF: the port's within TOL_ADMM (ADMM) or TOL_GD (FISTA) of a
  fresh JAX solver on the port's PSF and measurement;
- the JAX bot's fault (``ROADMAP.md``, notes on the reference, item 8):
  its solver cache is keyed on ``(algo, psf.shape)``, so a second user's
  request and a ``/random_mask`` request are solved with the first user's
  PSF, far from a fresh JAX ADMM on their own PSF; the port's are not;
- the narrowed fallback: a learned algorithm without weights falls back
  to ADMM and says so, any other fault of the zoo raises, and a checkpoint
  at hand runs as the zoo's model (the JAX bot calls the tuple that its
  ``load_model`` returns: item 9 of the same notes);
- ``BotState.check_message`` against the JAX one under an injected clock
  (busy, stale, the day's limit, the whitelist, the midnight reset), and
  the same paths through the handlers.

``/random_mask`` draws its seed from the global ``np.random``, as the JAX
bot does; the tests seed it.
"""

import asyncio
import os
import re
import sys
import types
from datetime import datetime, timedelta, timezone
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from test_torch_scripts import (APPS, TOL_ADMM, TOL_GD, TOL_SIM, _nerr, _png_levels, _run,
                                one_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

MASK = "mask={shape: [18, 26], center: [57, 77], downsample: 16}"
N_ITER = "n_iter={admm: 5, fista: 5, unrolled: 5}"


@pytest.fixture(autouse=True)
def cpu_platform(monkeypatch):
    monkeypatch.setenv("LPT_PLATFORM", "cpu")


class StandInTelegram:
    """``chip_smoke.stand_in_telegram``'s ``telegram`` / ``telegram.ext``
    modules in ``sys.modules``: the application records its handlers,
    ``run_polling`` returns at once."""

    def __init__(self, monkeypatch):
        import chip_smoke as cs

        modules, self.apps = cs.stand_in_telegram()
        for name, mod in modules.items():
            monkeypatch.setitem(sys.modules, name, mod)


class Chat:
    """Drives one bot's handlers with fake updates; ``replies`` holds
    ``(user, kind, text or caption)`` of every answer, timings blanked."""

    def __init__(self, handlers):
        self.handlers = {(kind, name): cb for kind, name, cb in handlers}
        self.replies, self.photos = [], []
        self.on_reply = None
        self._id = 0

    def _update(self, user, text=None, photo=None, date=None, age_s=0.0):
        chat, self._id = self, self._id + 1

        class Message:
            message_id = self._id

            async def reply_text(self, text, **kw):
                chat.replies.append((user, "text", text))
                if chat.on_reply is not None:
                    hook, chat.on_reply = chat.on_reply, None
                    await hook(text)

            async def reply_photo(self, f, caption=None, **kw):
                chat.replies.append((user, "photo", re.sub(r"\d+\.\d s", "# s", caption or "")))
                chat.photos.append(f.read())

        msg = Message()
        msg.date = date or datetime.now(timezone.utc) - timedelta(seconds=age_s)
        msg.text, msg.photo = text, photo
        return types.SimpleNamespace(message=msg, effective_user=types.SimpleNamespace(id=user))

    async def acommand(self, name, user, args=(), **kw):
        await self.handlers[("command", name)](self._update(user, **kw),
                                               types.SimpleNamespace(args=list(args)))

    def command(self, name, user, args=(), **kw):
        asyncio.run(self.acommand(name, user, args, **kw))

    def photo(self, user, fp_src, **kw):
        class File:
            async def download_to_drive(self, path):
                Path(path).write_bytes(Path(fp_src).read_bytes())

        class Size:
            async def get_file(self):
                return File()

        asyncio.run(self.handlers[("message", "photo")](
            self._update(user, photo=[Size()], **kw), None))

    def text(self, user, text):
        asyncio.run(self.handlers[("message", "text")](self._update(user, text=text), None))

    def button(self, user, algo):
        query_user = types.SimpleNamespace(id=user)
        msg = self._update(user).message

        async def answer():
            pass

        update = types.SimpleNamespace(callback_query=types.SimpleNamespace(
            answer=answer, data=algo, from_user=query_user, message=msg))
        asyncio.run(self.handlers[("callback", None)](update, None))


def start_bot(mod, tmp_path, monkeypatch, *extra):
    """The bot of ``mod`` (the JAX or the port's module) started on the
    stand-in telegram in ``tmp_path``: (chat, records), where ``records``
    lists each request's (algo, psf, data, result)."""
    records = []
    make_rig, make_reconstructor = mod.make_rig, mod.make_reconstructor

    def rig(*a, **kw):
        measure = make_rig(*a, **kw)

        def recorded(*m):
            psf, data = measure(*m)
            records.append([None, np.asarray(psf), np.asarray(data), None])
            return psf, data
        return recorded

    def reconstructor(*a, **kw):
        reconstruct = make_reconstructor(*a, **kw)

        def recorded(algo, psf, data):
            res = reconstruct(algo, psf, data)
            records[-1][0], records[-1][3] = algo, np.asarray(res)
            return res
        return recorded

    monkeypatch.setattr(mod, "make_rig", rig)
    monkeypatch.setattr(mod, "make_reconstructor", reconstructor)
    tg = StandInTelegram(monkeypatch)
    tmp_path.mkdir(parents=True, exist_ok=True)
    global_psf = tmp_path / "global_psf.png"
    cv2.imwrite(str(global_psf), np.full((8, 8, 3), 200, np.uint8))
    port, jax_app, entry = APPS["demo_apps.telegram_bot"]
    _run(getattr(mod, entry), ["token=abc", f"psf={global_psf}", "dummy=True", MASK, N_ITER,
                               *extra], tmp_path)
    (app,) = tg.apps
    assert app.token == "abc"
    return Chat(app.handlers), records


@pytest.fixture(scope="module")
def portrait(tmp_path_factory):
    """A seeded portrait JPEG (48 x 36) and a landscape one."""
    root = tmp_path_factory.mktemp("photos")
    yy, xx = np.mgrid[0:48, 0:36] / 48.0
    img = np.stack([0.5 + 0.5 * np.sin(7 * xx + c + 3 * yy) for c in range(3)], -1)
    cv2.imwrite(str(root / "portrait.jpg"), (img * 255).astype(np.uint8))
    cv2.imwrite(str(root / "landscape.jpg"), (img.transpose(1, 0, 2) * 255).astype(np.uint8))
    return root


def _fresh_jax(algo, psf, data):
    """A new JAX solver on this PSF and measurement (the unrolled
    fallback is ADMM), 5 iterations."""
    from lenslesspicam_tpu import ADMM, FISTA

    solver = (FISTA if algo == "fista" else ADMM)(psf)
    solver.set_data(data)
    return np.asarray(solver.apply(n_iter=5))


def _requests(chat, portrait):
    """User 1's photo (ADMM), /fista, /unrolled (no weights: ADMM); user 2's
    photo; user 1's /random_mask."""
    chat.photo(1, portrait / "portrait.jpg")
    chat.command("fista", 1)
    chat.command("unrolled", 1)
    chat.photo(2, portrait / "portrait.jpg")
    np.random.seed(3)
    chat.command("random_mask", 1)


def test_bot_matches_jax_and_uses_each_users_psf(tmp_path, monkeypatch, capsys, portrait):
    """The same replies; user PSFs within TOL_SIM; each port result within
    the tolerance of a fresh JAX solver on its own PSF and measurement,
    where the JAX bot's second user and ``/random_mask`` results are far
    from it (the cache keyed on the PSF's shape)."""
    from lenslesspicam_tpu.data.io import load_psf as j_load_psf
    from lenslesspicam_tpu_torch.data.io import load_psf as t_load_psf

    port, jax_app, _ = APPS["demo_apps.telegram_bot"]
    monkeypatch.chdir(tmp_path)             # no zoo folder named "unrolled" here
    chats, recs = {}, {}
    for side, mod in (("jax", jax_app), ("port", port)):
        chats[side], recs[side] = start_bot(mod, tmp_path / side, monkeypatch)
        _requests(chats[side], portrait)
    assert chats["port"].replies == chats["jax"].replies
    assert [r[0] for r in recs["port"]] == ["admm", "fista", "unrolled", "admm", "admm"]
    assert [r[0] for r in recs["jax"]] == [r[0] for r in recs["port"]]
    assert capsys.readouterr().out.count("unrolled: no weights") == 1     # the port's only
    for user, name in ((1, "psf"), (2, "psf"), (1, "psf_bad")):
        a, b = (tmp_path / s / str(user) / f"{name}.npy" for s in ("port", "jax"))
        assert _nerr(np.load(a), np.load(b)) <= TOL_SIM
        assert _png_levels(a.with_suffix(".png"), b.with_suffix(".png")) <= 1
    users = {s: [load(str(tmp_path / s / u / n), downsample=4) for u, n in
                 (("1", "psf.png"), ("2", "psf.png"), ("1", "psf_bad.png"))]
             for s, load in (("jax", j_load_psf), ("port", t_load_psf))}
    want_psf = [0, 0, 0, 1, 2]          # each request's own user PSF
    for i, (algo, psf, data, res) in enumerate(recs["port"]):
        assert np.array_equal(psf, users["port"][want_psf[i]])
        tol = TOL_GD if algo == "fista" else TOL_ADMM
        assert _nerr(res, _fresh_jax(algo, psf, data)) <= tol, i
    for i, (algo, psf, data, res) in enumerate(recs["jax"]):
        assert np.array_equal(psf, users["jax"][want_psf[i]])
        err = _nerr(res, _fresh_jax(algo, psf, data))
        if i < 3:
            assert err <= (TOL_GD if algo == "fista" else TOL_ADMM), i
        else:                           # the JAX bot solved with user 1's PSF
            assert err > 1e-2, (i, err)
    # the PSFs differ, so the results must too
    assert _nerr(recs["port"][3][1], recs["port"][0][1]) > 1e-2
    assert _nerr(recs["port"][4][1], recs["port"][0][1]) > 1e-2


def test_bot_replies_and_commands(tmp_path, monkeypatch, portrait):
    """/start, /help, /psf, /brightness, /exposure (valid and not), a
    landscape photo, text, an emoji through ``render_emoji``, the inline
    button, /random_mask before a photo, /rm_busy from an admin and from a
    user: the same replies from both bots."""
    port, jax_app, _ = APPS["demo_apps.telegram_bot"]
    chats = {}
    for side, mod in (("jax", jax_app), ("port", port)):
        monkeypatch.chdir(tmp_path)
        chat, _ = start_bot(mod, tmp_path / side, monkeypatch, "admins=[7]")
        chat.command("start", 1)
        chat.command("help", 1)
        chat.command("brightness", 1, ["50"])
        chat.command("brightness", 1, ["500"])
        chat.command("brightness", 1, [])
        chat.command("exposure", 1, ["0.1"])
        chat.command("exposure", 1, ["x"])
        chat.command("random_mask", 3)
        chat.command("admm", 3)
        chat.photo(3, portrait / "landscape.jpg")
        chat.text(1, "hello")
        chat.text(1, "/admm")
        chat.text(1, "☺")
        chat.button(3, "fista")                             # user 3's landscape, FISTA
        chat.command("psf", 4)
        chat.command("rm_busy", 1)
        chat.command("rm_busy", 7)
        chats[side] = chat
    assert chats["port"].replies == chats["jax"].replies
    texts = [r[2] for r in chats["port"].replies]
    assert "Brightness set to 50.0." in texts and "Exposure set to 0.1 s." in texts
    assert "Please send a portrait photo." in texts and "Busy flag cleared." in texts
    assert "Send a photo first." in texts
    assert texts.count("Supported text for display is only a single emoji.") == 1
    assert [r[2] for r in chats["port"].replies if r[1] == "photo"] == [
        "Reconstruction (admm), # s", "Reconstruction (fista), # s",
        "PSF used for your reconstructions"]
    psf_png = [cv2.imdecode(np.frombuffer(chats[s].photos[-1], np.uint8), cv2.IMREAD_UNCHANGED)
               .astype(int) for s in ("port", "jax")]               # user 4's PSF PNG
    assert np.abs(psf_png[0] - psf_png[1]).max() <= 1


def test_bot_overlays(tmp_path, monkeypatch, portrait):
    """Up to three watermark overlays on the reconstruction, as the JAX bot
    draws them."""
    mark = tmp_path / "mark.png"
    cv2.imwrite(str(mark), (np.random.RandomState(22).rand(10, 20, 3) * 255).astype(np.uint8))
    port, jax_app, _ = APPS["demo_apps.telegram_bot"]
    ov = f"overlays=[{{fp: {mark}, scaling: 0.5, position: [3, 4]}}]"
    out = {}
    for side, mod in (("jax", jax_app), ("port", port)):
        chat, _ = start_bot(mod, tmp_path / side, monkeypatch, ov, "overlay_alpha=120")
        chat.photo(1, portrait / "portrait.jpg")
        out[side] = tmp_path / side / "1" / "reconstructed_overlay.png"
        assert out[side].is_file()
    assert _png_levels(out["port"], out["jax"]) <= 1


def test_bot_gates_through_the_handlers(tmp_path, monkeypatch, portrait):
    """A stale message, the day's limit (a whitelisted user exempt) and a
    request while the camera is busy: the same refusals from both bots."""
    port, jax_app, _ = APPS["demo_apps.telegram_bot"]
    chats = {}
    for side, mod in (("jax", jax_app), ("port", port)):
        chat, _ = start_bot(mod, tmp_path / side, monkeypatch, "max_queries_per_day=2",
                            "whitelist=[9]", "timeout_s=30")
        chat.command("admm", 1, age_s=45.0)                 # stale
        chat.command("admm", 1)
        chat.command("admm", 1)                             # the second query of the day
        chat.command("admm", 1)                             # over the limit
        for _ in range(3):
            chat.command("admm", 9)                         # whitelisted

        async def while_busy(text):
            if text == "Taking picture...":
                await chat.acommand("fista", 5)
        chat.on_reply = None
        chat.photo(9, portrait / "portrait.jpg")            # over 2, whitelisted: served
        chat.on_reply = while_busy
        chat.command("admm", 9)
        chats[side] = chat
    assert chats["port"].replies == chats["jax"].replies
    texts = [r[2] for r in chats["port"].replies]
    assert texts[0].startswith("Timeout (30 seconds) exceeded.")
    assert texts.count("Maximum number of queries per day (2) exceeded. "
                       "Please try again tomorrow.") == 1
    assert (5, "text", "System is busy. Please wait for the current job to finish and try "
                       "again.") in chats["port"].replies


class _Clock:
    """A stand-in ``datetime`` for the bot modules: ``now`` reads ``t``."""

    def __init__(self, t):
        self.t = t

    def now(self, tz=None):
        return self.t


def test_check_message_matches_jax(monkeypatch):
    """``BotState.check_message`` under an injected clock: the same answers
    as the JAX bot's over busy, stale and skewed messages, the day's
    limit, the whitelist and the reset at midnight."""
    port, jax_app, _ = APPS["demo_apps.telegram_bot"]
    t0 = datetime(2026, 3, 1, 23, 59, 0, tzinfo=timezone.utc)
    config = {**port._DEFAULTS, "max_queries_per_day": 2, "whitelist": [9], "timeout_s": 60,
              "time_offset_s": 5}
    answers = {}
    for side, mod in (("jax", jax_app), ("port", port)):
        clock = _Clock(t0)
        monkeypatch.setattr(mod, "datetime", clock)
        state = mod.BotState(config)
        seq = []
        for user, sent, now in ((1, t0, t0), (1, t0 - timedelta(seconds=64), t0),
                                (1, t0 - timedelta(seconds=66), t0), (1, t0, t0), (1, t0, t0),
                                (9, t0, t0), (9, t0, t0), (9, t0, t0),
                                (1, t0 + timedelta(minutes=2), t0 + timedelta(minutes=2))):
            clock.t = now
            seq.append(state.check_message(user, sent))
        state.busy = True
        seq.append(state.check_message(1, clock.t))
        answers[side] = seq
    assert answers["port"] == answers["jax"]
    assert answers["port"][0] is None and answers["port"][1] is None
    assert answers["port"][2].startswith("Timeout")
    assert answers["port"][4].startswith("Maximum number of queries per day (2)")
    assert answers["port"][5:8] == [None] * 3
    assert answers["port"][8] is None                 # a new day: the counts reset
    assert answers["port"][9].startswith("System is busy")


def test_learned_fallback_is_narrow(tmp_path, monkeypatch, portrait, capsys):
    """No weights (``FileNotFoundError``): ADMM, and the bot says so; any
    other fault of the zoo raises."""
    from lenslesspicam_tpu_torch.zoo import model_dict

    port, _, _ = APPS["demo_apps.telegram_bot"]
    chat, recs = start_bot(port, tmp_path / "a", monkeypatch)
    monkeypatch.chdir(tmp_path)
    chat.photo(1, portrait / "portrait.jpg")
    chat.command("unrolled", 1)
    assert "unrolled: no weights (no embedded config at unrolled" in capsys.readouterr().out
    assert _nerr(recs[1][3], recs[0][3]) == 0.0       # the same ADMM on the same inputs

    def corrupt(*a, **kw):
        raise RuntimeError("checkpoint does not fit the config")

    monkeypatch.setattr(model_dict, "load_model", corrupt)
    chat, _ = start_bot(port, tmp_path / "b", monkeypatch)
    chat.photo(1, portrait / "portrait.jpg")
    with pytest.raises(RuntimeError, match="does not fit"):
        chat.command("unrolled", 1)
    chat.command("admm", 1)                           # the busy flag was released
    assert chat.replies[-1][1] == "photo"


def test_learned_checkpoint_runs_as_the_zoo_model(tmp_path, monkeypatch, portrait):
    """A checkpoint folder named by the algorithm: the bot's result is the
    zoo's model on the request's measurement and PSF.  The JAX bot calls
    the tuple that its ``load_model`` returns and raises (``ROADMAP.md``,
    notes on the reference, item 9)."""
    import chip_smoke as cs
    from lenslesspicam_tpu_torch.zoo.model_dict import load_model

    monkeypatch.chdir(tmp_path)
    cs._cli_zoo_checkpoint(str(tmp_path / "unrolled"), {"reconstruction": {
        "method": "unrolled_admm", "unrolled_admm": {"n_iter": cs.CLI_ZOO_N},
        "pre_process": {"network": None}, "post_process": {"network": None}}})
    port, _, _ = APPS["demo_apps.telegram_bot"]
    chat, recs = start_bot(port, tmp_path / "bot", monkeypatch)
    chat.photo(1, portrait / "portrait.jpg")
    chat.command("unrolled", 1)
    algo, psf, data, res = recs[-1]
    model, _ = load_model(str(tmp_path / "unrolled"), device="cpu")
    with torch.no_grad():
        ref = model(data[None], psf)[0].numpy()
    assert algo == "unrolled" and res.shape == ref.shape == data.shape
    assert _nerr(res, ref) == 0.0
    assert os.path.isfile(tmp_path / "bot" / "1" / "reconstructed.png")
    _, jax_app, _ = APPS["demo_apps.telegram_bot"]
    chat, _ = start_bot(jax_app, tmp_path / "jax_bot", monkeypatch)
    chat.photo(1, portrait / "portrait.jpg")
    with pytest.raises(TypeError, match="'tuple' object is not callable"):
        chat.command("unrolled", 1)
