"""Launchers of the port: the serve launcher and the fleet dry run."""
