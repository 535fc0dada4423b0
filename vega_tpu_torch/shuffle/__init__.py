"""The host tier's shuffle plane (the port's copy of vega_tpu/shuffle/
for the local runtime): the budgeted bucket store and the fetcher that
reduce tasks read it through."""
