"""Serving: the exported bundle (``export``) and the predictor behind the
CLIs (``predictor``).  ``export_bundle`` and ``load_bundle`` import
nothing of the port's models, training or CLIs."""

from .export import export_bundle, load_bundle  # noqa: F401
