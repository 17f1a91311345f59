"""The port's benchmark tools: data files and corpora (``dataformat``), the
reference protocol (``countmatches``, ``driver``, ``naive``, ``report``),
the ``BASELINE.json`` configs (``configs``), the criterion matrix
(``micro``) and weak scaling over a mesh (``scaling``).  Each runs with
``python -m alfred_margaret_tpu_torch.bench.<module>``, on the card unless
``--device cpu`` is given."""
