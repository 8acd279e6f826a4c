"""Host-side CF semantics (calendars, units) and the ClimArray data model."""
