"""Ingest pipelines: pre-index document processor chains.

Reference analogs: org.elasticsearch.ingest.IngestService
.executeBulkRequest, Pipeline/CompoundProcessor, the Processor SPI, and
the built-in processor pack in modules/ingest-common (SURVEY.md §2.1
Ingest row, §2.3 ingest-common, §3.2 "IngestService.executeBulkRequest
(if pipelines)").
"""

from .service import IngestError, IngestService, Pipeline, PROCESSOR_TYPES

__all__ = ["IngestError", "IngestService", "Pipeline", "PROCESSOR_TYPES"]
