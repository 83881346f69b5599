"""The port's ``scripts/demo_apps`` app: the Telegram demo bot."""
