"""The share of the traced window in which no kernel, copy or memset ran on
the card, in %.  It reads ``device_idle_pct.resident`` (resident queries,
moving ``scan_GBps``) and ``device_idle_pct.ingest`` (one-shot counts,
moving ``ingest_GBps``) alike."""


def read(run):
    return run.idle_pct()
