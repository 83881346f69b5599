"""The Telegram demo bot (the port of ``scripts/demo_apps/telegram_bot.py``).

A user sends a portrait photo (or one emoji); the bot shows it on the
camera's screen, captures a measurement and sends back its
reconstruction.  Each user has a working folder and, with a DigiCam
(``mask``), a PSF simulated from a mask seeded by the user's id: the PSF
is their key.  A busy flag serializes the one camera; queries are limited
per day (``whitelist`` exempts users); stale messages are refused;
watermark overlays; inline buttons pick the algorithm; commands
``/fista /admm /unrolled /unet /brightness /exposure /psf /random_mask
/rm_busy /help``.  Reconstruction runs in this process on the app's device
(the port's ``ADMM`` / ``FISTA``, learned models from the zoo).  With
``dummy: true`` the measurement is simulated by convolving the displayed
image with the user's PSF on the device (``ops.fft_conv.FFTConvolver``),
so the whole pipeline runs without the camera.

    python -m lenslesspicam_tpu_torch.scripts.demo_apps.telegram_bot token=<token> psf=psf.png

Reads the JAX app's ``_DEFAULTS``; needs python-telegram-bot (imported in
``_bot_main``).  Deliberate differences from the JAX app:

- The solvers are cached by the PSF itself (a digest of its bytes), one
  per algorithm.  The JAX app keys its cache on ``(algo, psf.shape)``, so
  with a ``mask`` config every request after the first is solved with the
  first request's PSF, whatever the user's or the ``/random_mask`` PSF.
- A learned algorithm falls back to ADMM only when the zoo finds no
  weights (``zoo.model_dict.load_model`` raises ``FileNotFoundError``:
  no ``.hydra/config.yaml`` or no ``recon_epoch*`` in the folder named by
  the algorithm), and the bot prints that it fell back.  Any other fault
  raises.  The JAX app falls back on any exception.
- A learned model runs as ``model(data, psf)``.  The JAX app calls the
  tuple that ``load_model`` returns, which cannot run.
"""

import hashlib
import os
import time
from datetime import datetime, timezone

import numpy as np

from .._common import app

ALGOS = ("fista", "admm", "unrolled", "unet")

_DEFAULTS = {
    "token": None,               # or TELEGRAM_BOT_TOKEN env
    "psf": None,                 # or DEMO_PSF env
    "rpi": {"username": None, "hostname": None},
    "dummy": False,              # simulate measurements (no rig)
    "downsample": 4,
    "n_iter": {"fista": 100, "admm": 100},
    "capture": {"exp": 0.02, "bayer": True,
                "max_exp": 0.6, "min_exp": 0.001},
    "display": {"brightness": 100, "max_brightness": 100},
    "timeout_s": 60,             # ignore messages older than this
    "time_offset_s": 0,          # clock skew allowance
    "max_queries_per_day": 30,
    "whitelist": [],             # user ids exempt from the rate limit
    "admins": [],                # user ids allowed /rm_busy
    "overlays": [],              # [{fp, scaling, position: [x, y]}] x<=3
    "overlay_alpha": 90,
    "mask": None,                # DigiCam per-user mask: {shape, center,
                                 #  sensor, device, downsample, flipud}
    "output_dir": "bot_users",
}

HELP_TEXT = (
    "Send a portrait photo (or a single emoji) and I will display it on "
    "the lensless camera, capture a measurement, and reconstruct it.\n"
    "Commands:\n"
    "  /fista /admm /unrolled /unet — reconstruct the last photo with "
    "that algorithm\n"
    "  /psf — see the PSF used for your reconstructions\n"
    "  /brightness <0-100> — set display brightness\n"
    "  /exposure <seconds> — set capture exposure\n"
    "  /random_mask — reconstruct with a WRONG mask (DigiCam demo)\n"
    "  /help — this message"
)


class BotState:
    """The rig's state: the busy flag, the queries per user and day, the
    users' algorithms, brightness and exposure."""

    def __init__(self, config):
        self.config = config
        self.busy = False
        self.queries = {}
        self.queries_day = datetime.now(timezone.utc).date()
        self.user_algo = {}
        self.brightness = config["display"]["brightness"]
        self.exposure = config["capture"]["exp"]

    def check_message(self, user_id, message_date):
        """The reason to refuse a message (busy, stale, over the day's
        limit), or None; counts the query."""
        if self.busy:
            return ("System is busy. Please wait for the current job to "
                    "finish and try again.")
        now = datetime.now(timezone.utc)
        diff = (now - message_date).total_seconds() \
            - self.config["time_offset_s"]
        if diff > self.config["timeout_s"]:
            return (f"Timeout ({self.config['timeout_s']} seconds) "
                    "exceeded. Someone else may be using the system. "
                    "Please send a new message.")
        if now.date() != self.queries_day:   # midnight reset
            self.queries = {}
            self.queries_day = now.date()
        self.queries[user_id] = self.queries.get(user_id, 0) + 1
        if (user_id not in self.config["whitelist"]
                and self.queries[user_id]
                > self.config["max_queries_per_day"]):
            return (f"Maximum number of queries per day "
                    f"({self.config['max_queries_per_day']}) exceeded. "
                    "Please try again tomorrow.")
        return None


def user_folder(config, user_id):
    folder = os.path.join(config["output_dir"], str(user_id))
    os.makedirs(folder, exist_ok=True)
    return folder


def ensure_user_psf(config, user_id, folder, bad=False, seed_extra=0, device=None):
    """With a DigiCam (``mask``), the user's PSF: the mask seeded by
    ``user_id + seed_extra`` is set on the LCD (unless ``dummy``) and its
    PSF simulated by ``AdafruitLCD`` on ``device``, saved as ``psf.png``
    (``psf_bad.png`` for the ``/random_mask`` demo, made anew each time)
    and ``.npy``.  Returns the PSF's path, or the global PSF without a
    mask model."""
    from ...data.io import save_image

    if config["mask"] is None:
        return config["psf"]
    name = "psf_bad" if bad else "psf"
    psf_fp = os.path.join(folder, f"{name}.png")
    if os.path.isfile(psf_fp) and not bad:
        return psf_fp

    import torch

    from ..._device import as_host
    from ...hardware.slm import adafruit_sub2full
    from ...hardware.trainable_mask import AdafruitLCD

    mcfg = config["mask"]
    rng = np.random.RandomState((user_id + seed_extra) % (2 ** 32 - 1))
    mask_vals = rng.uniform(0, 1, tuple(mcfg["shape"])).astype(np.float32)
    if not config["dummy"]:
        from ...hardware import remote

        full_pattern = adafruit_sub2full(mask_vals,
                                         center=tuple(mcfg["center"]))
        remote.set_programmable_mask(
            full_pattern, mcfg.get("device", "adafruit"),
            rpi_username=config["rpi"]["username"],
            rpi_hostname=config["rpi"]["hostname"])
    mask = AdafruitLCD(initial_vals=mask_vals,
                       sensor=mcfg.get("sensor", "rpi_hq"),
                       slm=mcfg.get("device", "adafruit"),
                       downsample=mcfg.get("downsample", 8),
                       flipud=mcfg.get("flipud", False), device=device)
    with torch.no_grad():
        psf = as_host(mask.get_psf(mask.params))
    save_image(psf[0], psf_fp)
    np.save(psf_fp.replace(".png", ".npy"), psf)
    return psf_fp


def apply_overlays(config, recon_fp):
    """Watermark the reconstruction with up to three overlay images."""
    if not config["overlays"]:
        return recon_fp
    from PIL import Image

    img = Image.open(recon_fp).convert("RGBA")
    for ov in config["overlays"][:3]:
        mark = Image.open(ov["fp"]).convert("RGBA")
        mark.putalpha(config["overlay_alpha"])
        new_w = int(img.width * ov.get("scaling", 0.2))
        mark = mark.resize((new_w, int(new_w * mark.height / mark.width)))
        img.paste(mark, tuple(ov.get("position", [0, 0])), mark)
    out_fp = recon_fp.replace(".png", "_overlay.png")
    img.convert("RGB").save(out_fp)
    return out_fp


def render_emoji(text, folder, size=512):
    """Draw one emoji or character on a black portrait canvas to display."""
    from PIL import Image, ImageDraw, ImageFont

    img = Image.new("RGB", (size, int(size * 4 / 3)), "black")
    draw = ImageDraw.Draw(img)
    font = None
    for fp in ("/usr/share/fonts/truetype/noto/NotoColorEmoji.ttf",
               "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf"):
        if os.path.isfile(fp):
            try:
                font = ImageFont.truetype(fp, size=min(size // 2, 109))
                break
            except OSError:
                continue
    draw.text((size // 2, img.height // 2), text, fill="white",
              font=font, anchor="mm")
    fp = os.path.join(folder, "emoji.png")
    img.save(fp)
    return fp


def make_rig(config, state, device=None):
    """``measure(display_fp, folder, psf_fp) -> (psf, data)``: display,
    capture and load; the dummy rig convolves the displayed image with the
    PSF on ``device`` instead."""

    def measure(display_fp, folder, psf_fp):
        from ...data.io import load_data

        if config["dummy"]:
            import torch

            from ..._device import as_host
            from ...data.io import load_image, load_psf
            from ...ops.fft_conv import FFTConvolver

            psf = load_psf(psf_fp, downsample=config["downsample"],
                           return_float=True)
            img = load_image(display_fp, return_float=True,
                             shape=psf.shape[-3:])
            fwd = FFTConvolver.from_psf(psf, pad=True, norm="backward", device=device)
            meas = as_host(fwd.convolve(torch.from_numpy(np.ascontiguousarray(
                img[None], np.float32)).to(fwd.H.device)))[0]
            meas = meas / max(meas.max(), 1e-9)
            return psf, meas[None]
        from ...hardware import remote

        remote.display(display_fp, config["rpi"]["username"],
                       config["rpi"]["hostname"],
                       brightness=state.brightness)
        raw_fp, _ = remote.capture(
            config["rpi"]["username"], config["rpi"]["hostname"],
            exp=state.exposure, output_path=folder,
            **{k: v for k, v in config["capture"].items()
               if k not in ("exp", "max_exp", "min_exp")})
        return load_data(psf_fp, raw_fp, downsample=config["downsample"])

    return measure


def _digest(psf):
    psf = np.ascontiguousarray(psf)
    return hashlib.sha256(psf.tobytes()).hexdigest(), psf.shape, psf.dtype.str


def make_reconstructor(config, device=None):
    """``reconstruct(algo, psf, data)``: the solver of ``algo`` for this
    PSF, kept while the same PSF comes back (one per algorithm), applied
    to ``data``; a numpy ``(depth, H, W, C)`` result."""
    import torch

    from ... import ADMM, FISTA
    from ..._device import as_host
    from ...zoo.model_dict import load_model

    cache = {}

    def build(algo, psf):
        if algo == "fista":
            return FISTA(psf, device=device)
        if algo == "admm":
            return ADMM(psf, device=device)
        # learned models come from the zoo when their weights are at hand;
        # otherwise ADMM
        try:
            loaded = load_model(algo, device=device)
        except FileNotFoundError as e:
            print(f"{algo}: no weights ({e}); falling back to ADMM")
            return ADMM(psf, device=device)
        model, model_psf = loaded[0], (loaded[2] if len(loaded) == 3 else psf)

        def run(data):
            with torch.no_grad():
                return model(np.asarray(data)[None], model_psf)[0]

        return run

    def reconstruct(algo, psf, data):
        key = _digest(psf)
        if algo not in cache or cache[algo][0] != key:
            cache[algo] = (key, build(algo, psf))
        solver = cache[algo][1]
        if hasattr(solver, "set_data"):
            solver.set_data(data)
            n = config["n_iter"].get(algo, 100)
            return as_host(solver.apply(n_iter=n))
        return as_host(solver(data))

    return reconstruct


def main():
    _bot_main()


@app(None)
def _bot_main(config, device):
    from ...utils.config import apply_defaults

    apply_defaults(config, _DEFAULTS)
    config["token"] = config["token"] or os.environ.get("TELEGRAM_BOT_TOKEN")
    config["psf"] = config["psf"] or os.environ.get("DEMO_PSF")
    config["rpi"]["username"] = (config["rpi"]["username"]
                                 or os.environ.get("RPI_USERNAME"))
    config["rpi"]["hostname"] = (config["rpi"]["hostname"]
                                 or os.environ.get("RPI_HOSTNAME"))
    assert config["token"] and config["psf"], "set token and psf"

    try:
        from telegram import (InlineKeyboardButton, InlineKeyboardMarkup,
                              Update)
        from telegram.ext import (ApplicationBuilder, CallbackQueryHandler,
                                  CommandHandler, MessageHandler, filters)
    except ImportError as e:
        raise ImportError(
            "requires python-telegram-bot; run on the demo host") from e

    from ...data.io import save_image

    state = BotState(config)
    measure = make_rig(config, state, device)
    reconstruct = make_reconstructor(config, device)

    async def gate(update):
        """Run the incoming-message checks; reply + False when denied."""
        msg = state.check_message(update.effective_user.id,
                                  update.message.date)
        if msg:
            await update.message.reply_text(
                msg, reply_to_message_id=update.message.message_id)
            return False
        return True

    async def run_pipeline(update, algo, display_fp, bad_mask=False):
        user_id = update.effective_user.id
        folder = user_folder(config, user_id)
        seed_extra = np.random.randint(0, 1000) if bad_mask else 0
        psf_fp = ensure_user_psf(config, user_id, folder, bad=bad_mask,
                                 seed_extra=seed_extra, device=device)
        state.busy = True
        try:
            t0 = time.time()
            await update.message.reply_text(
                "Taking picture...",
                reply_to_message_id=update.message.message_id)
            psf, data = measure(display_fp, folder, psf_fp)
            res = reconstruct(algo, psf, data)
            out_fp = os.path.join(folder, "reconstructed.png")
            save_image(res[0], out_fp)
            out_fp = apply_overlays(config, out_fp)
            with open(out_fp, "rb") as f:
                await update.message.reply_photo(
                    f, caption=f"Reconstruction ({algo}), "
                               f"{time.time() - t0:.1f} s",
                    reply_to_message_id=update.message.message_id)
            if bad_mask:
                with open(psf_fp, "rb") as f:
                    await update.message.reply_photo(
                        f, caption="Incorrect PSF used for reconstruction")
                good = ensure_user_psf(config, user_id, folder, device=device)
                if good != config["psf"]:
                    with open(good, "rb") as f:
                        await update.message.reply_photo(
                            f, caption="Correct PSF (your key)")
        finally:
            state.busy = False

    async def start_cmd(update: Update, context):
        await update.message.reply_text(HELP_TEXT)

    async def algo_cmd(update: Update, context, algo):
        """(Re)reconstruct this user's last photo with the given algo."""
        if not await gate(update):
            return
        folder = user_folder(config, update.effective_user.id)
        last = os.path.join(folder, "input.jpg")
        state.user_algo[update.effective_user.id] = algo
        if not os.path.isfile(last):
            await update.message.reply_text(
                f"Algorithm set to {algo}. Send a photo to reconstruct.")
            return
        await run_pipeline(update, algo, last)

    async def photo_handler(update: Update, context):
        if not await gate(update):
            return
        folder = user_folder(config, update.effective_user.id)
        photo_fp = os.path.join(folder, "input.jpg")
        file = await update.message.photo[-1].get_file()
        await file.download_to_drive(photo_fp)
        from PIL import Image

        with Image.open(photo_fp) as img:
            size = img.size
        if size[1] < size[0]:
            await update.message.reply_text(
                "Please send a portrait photo.",
                reply_to_message_id=update.message.message_id)
            return
        await update.message.reply_text(
            f"Got photo of resolution: {size[::-1]}",
            reply_to_message_id=update.message.message_id)
        keyboard = InlineKeyboardMarkup(
            [[InlineKeyboardButton(a.upper(), callback_data=a)
              for a in ALGOS]])
        default = state.user_algo.get(update.effective_user.id, "admm")
        await update.message.reply_text(
            f"Reconstructing with {default} — or pick another algorithm:",
            reply_markup=keyboard)
        await run_pipeline(update, default, photo_fp)

    async def button_handler(update: Update, context):
        query = update.callback_query
        await query.answer()
        algo = query.data
        folder = user_folder(config, query.from_user.id)
        last = os.path.join(folder, "input.jpg")
        if os.path.isfile(last) and not state.busy:
            state.user_algo[query.from_user.id] = algo
            update.message = query.message       # reuse pipeline plumbing
            update.effective_user = query.from_user
            await run_pipeline(update, algo, last)

    async def text_handler(update: Update, context):
        """A single emoji: display it and reconstruct."""
        text = (update.message.text or "").strip()
        if text.startswith("/"):
            return
        if len(text) != 1:
            await update.message.reply_text(
                "Supported text for display is only a single emoji.")
            return
        if not await gate(update):
            return
        folder = user_folder(config, update.effective_user.id)
        fp = render_emoji(text, folder)
        algo = state.user_algo.get(update.effective_user.id, "admm")
        await run_pipeline(update, algo, fp)

    async def brightness_cmd(update: Update, context):
        try:
            val = float(context.args[0])
            assert 0 <= val <= config["display"]["max_brightness"]
        except (IndexError, ValueError, AssertionError):
            await update.message.reply_text(
                f"Usage: /brightness <0-"
                f"{config['display']['max_brightness']}>")
            return
        state.brightness = val
        await update.message.reply_text(f"Brightness set to {val}.")

    async def exposure_cmd(update: Update, context):
        lo = config["capture"]["min_exp"]
        hi = config["capture"]["max_exp"]
        try:
            val = float(context.args[0])
            assert lo <= val <= hi
        except (IndexError, ValueError, AssertionError):
            await update.message.reply_text(
                f"Usage: /exposure <seconds in [{lo}, {hi}]>")
            return
        state.exposure = val
        await update.message.reply_text(f"Exposure set to {val} s.")

    async def psf_cmd(update: Update, context):
        folder = user_folder(config, update.effective_user.id)
        psf_fp = ensure_user_psf(config, update.effective_user.id, folder, device=device)
        with open(psf_fp, "rb") as f:
            await update.message.reply_photo(
                f, caption="PSF used for your reconstructions")

    async def random_mask_cmd(update: Update, context):
        if config["mask"] is None:
            await update.message.reply_text(
                "Random-mask demo needs a DigiCam (mask config).")
            return
        if not await gate(update):
            return
        folder = user_folder(config, update.effective_user.id)
        last = os.path.join(folder, "input.jpg")
        if not os.path.isfile(last):
            await update.message.reply_text("Send a photo first.")
            return
        await run_pipeline(update, "admm", last, bad_mask=True)

    async def rm_busy_cmd(update: Update, context):
        if update.effective_user.id not in config["admins"]:
            return
        state.busy = False
        await update.message.reply_text("Busy flag cleared.")

    app_ = ApplicationBuilder().token(config["token"]).build()
    app_.add_handler(CommandHandler("start", start_cmd))
    app_.add_handler(CommandHandler("help", start_cmd))
    for algo in ALGOS:
        app_.add_handler(CommandHandler(
            algo, lambda u, c, a=algo: algo_cmd(u, c, a)))
    app_.add_handler(CommandHandler("brightness", brightness_cmd))
    app_.add_handler(CommandHandler("exposure", exposure_cmd))
    app_.add_handler(CommandHandler("psf", psf_cmd))
    app_.add_handler(CommandHandler("random_mask", random_mask_cmd))
    app_.add_handler(CommandHandler("rm_busy", rm_busy_cmd))
    app_.add_handler(CallbackQueryHandler(button_handler))
    app_.add_handler(MessageHandler(filters.PHOTO, photo_handler))
    app_.add_handler(MessageHandler(filters.TEXT, text_handler))
    app_.run_polling()


if __name__ == "__main__":
    main()
