"""Host-side CF semantics (calendars, units, options, locales, metadata),
the ClimArray data model, missing-value masks and the indicator engine."""
