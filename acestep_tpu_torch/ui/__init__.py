"""The studio page the port's REST server serves at ``/`` and ``/studio``."""
