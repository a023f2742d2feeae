"""Audio: log-mel frontend, event classifier, processor (port of gvl_tpu.audio)."""
