# -*- coding: utf-8 -*-
# Generated by scripts/gen_proto.py (protoc is not available in the image).
# DO NOT EDIT BY HAND — edit scripts/gen_proto.py + downloader.proto and rerun.
# source: downloader.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x10downloader.proto\x12\rdownloader.v1"\x9c\x01\n\x05Media\x12\n\n\x02id\x18\x01 \x01(\t\x12\x12\n\ncreator_id\x18\x02 \x01(\t\x12\x0c\n\x04name\x18\x03 \x01(\t\x12&\n\x04type\x18\x04 \x01(\x0e2\x18.downloader.v1.MediaType\x12)\n\x06source\x18\x05 \x01(\x0e2\x19.downloader.v1.SourceType\x12\x12\n\nsource_uri\x18\x06 \x01(\t"\x8a\x02\n\x08Download\x12#\n\x05media\x18\x01 \x01(\x0b2\x14.downloader.v1.Media\x12\x12\n\ncreated_at\x18\x02 \x01(\t\x126\n\x08priority\x18\x03 \x01(\x0e2\x1a.downloader.v1.JobPriorityR\x08priority\x12\x16\n\x06tenant\x18\x04 \x01(\tR\x06tenant\x12\x1f\n\x0bttl_seconds\x18\x05 \x01(\x01R\nttlSeconds\x12\x18\n\x07mirrors\x18\x06 \x03(\tR\x07mirrors\x12:\n\x0bsource_kind\x18\x07 \x01(\x0e2\x19.downloader.v1.SourceKindR\nsourceKind"m\n\x07Convert\x12\x12\n\ncreated_at\x18\x01 \x01(\t\x12#\n\x05media\x18\x02 \x01(\x0b2\x14.downloader.v1.Media\x12)\n\x10deadline_seconds\x18\x03 \x01(\x01R\x0fdeadlineSeconds"X\n\x14TelemetryStatusEvent\x12\x10\n\x08media_id\x18\x01 \x01(\t\x12.\n\x06status\x18\x02 \x01(\x0e2\x1e.downloader.v1.TelemetryStatus"k\n\x16TelemetryProgressEvent\x12\x10\n\x08media_id\x18\x01 \x01(\t\x12.\n\x06status\x18\x02 \x01(\x0e2\x1e.downloader.v1.TelemetryStatus\x12\x0f\n\x07percent\x18\x03 \x01(\x05*9\n\nSourceType\x12\x0b\n\x07TORRENT\x10\x00\x12\x08\n\x04HTTP\x10\x01\x12\x08\n\x04FILE\x10\x02\x12\n\n\x06BUCKET\x10\x03*\x1e\n\tMediaType\x12\x06\n\x02TV\x10\x00\x12\t\n\x05MOVIE\x10\x01*\x84\x01\n\x0fTelemetryStatus\x12\x0b\n\x07CREATED\x10\x00\x12\n\n\x06QUEUED\x10\x01\x12\x0f\n\x0bDOWNLOADING\x10\x02\x12\x0e\n\nCONVERTING\x10\x03\x12\r\n\tUPLOADING\x10\x04\x12\x0c\n\x08DEPLOYED\x10\x05\x12\x0b\n\x07ERRORED\x10\x06\x12\r\n\tCANCELLED\x10\x07*-\n\x0bJobPriority\x12\n\n\x06NORMAL\x10\x00\x12\x08\n\x04HIGH\x10\x01\x12\x08\n\x04BULK\x10\x02*0\n\nSourceKind\x12\x08\n\x04AUTO\x10\x00\x12\n\n\x06DIRECT\x10\x01\x12\x0c\n\x08MANIFEST\x10\x02b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'downloader_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _SOURCETYPE._serialized_start=773
  _SOURCETYPE._serialized_end=830
  _MEDIATYPE._serialized_start=832
  _MEDIATYPE._serialized_end=862
  _TELEMETRYSTATUS._serialized_start=865
  _TELEMETRYSTATUS._serialized_end=997
  _JOBPRIORITY._serialized_start=999
  _JOBPRIORITY._serialized_end=1044
  _SOURCEKIND._serialized_start=1046
  _SOURCEKIND._serialized_end=1094
  _MEDIA._serialized_start=36
  _MEDIA._serialized_end=192
  _DOWNLOAD._serialized_start=195
  _DOWNLOAD._serialized_end=461
  _CONVERT._serialized_start=463
  _CONVERT._serialized_end=572
  _TELEMETRYSTATUSEVENT._serialized_start=574
  _TELEMETRYSTATUSEVENT._serialized_end=662
  _TELEMETRYPROGRESSEVENT._serialized_start=664
  _TELEMETRYPROGRESSEVENT._serialized_end=771
# @@protoc_insertion_point(module_scope)
