"""The roofline (port of :mod:`repro.roofline`): what a step costs
(:mod:`.hlo_parse`) and its three terms over a card's rates
(:mod:`.analysis`)."""
