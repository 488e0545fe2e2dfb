// Resident worker agent: event-driven task lifecycle over one channel.
//
// The stateless-files protocol (reference: covalent_ssh_plugin/ssh.py:363-432,
// one `conn.run` to submit plus a poll loop of `test -f` round-trips) costs a
// control-plane round-trip per status probe.  This agent replaces that with a
// single resident process per worker speaking newline-delimited JSON on
// stdin/stdout: the executor writes one `run` command and *completion is
// pushed* as an `exit` event the instant SIGCHLD fires — zero poll traffic,
// sub-millisecond task turnaround on the control plane.
//
// Protocol (one JSON object per line):
//   -> {"cmd":"ping"}
//   <- {"event":"pong"}
//   -> {"cmd":"run","id":"<op>","argv":["python3","harness.py","spec.json"],
//       "cwd":"/path","env":{"K":"V"},"log":"/path/log.txt"}
//   <- {"event":"started","id":"<op>","pid":1234}
//   <- {"event":"exit","id":"<op>","code":0,"signal":0}        (pushed)
//   -> {"cmd":"kill","id":"<op>","sig":15}
//   <- {"event":"killed","id":"<op>"}   (exit event still follows from reaper)
//   -> {"cmd":"watch","id":"<op>","path":"/path/telemetry.jsonl"}
//   <- {"event":"watching","id":"<op>"}
//   <- {"event":"telemetry","id":"<op>","data":{...}}     (per line, pushed)
//   -> {"cmd":"unwatch","id":"<op>"}
//   <- {"event":"unwatched","id":"<op>"}
//   -> {"cmd":"register_fn","digest":"<sha256>","path":"/cas/<sha256>.pkl",
//       "runner":["python3","/cache/cas/<sha256>.py","--rpc-child"]}
//   <- {"event":"registered","digest":"<sha256>"}
//   <- {"event":"register_error","digest":"...","code":"digest_mismatch"|
//       "missing","message":"..."}
//   -> {"cmd":"invoke","id":"<op>","digest":"<sha256>","spec":{...},
//       "args":"<b64>"}
//   <- {"event":"started","id":"<op>", ...}      (emitted by the runner)
//   <- {"event":"result","id":"<op>","ok":true,"data":"<b64>"}  (runner)
//   -> {"cmd":"serve_open","id":"<sid>","digest":"<sha256>","path":"...",
//       "runner":["python3","/cache/cas/<sha256>.py",
//       "--serve-child"],"options":{...},"spec":{...}}
//   <- {"event":"serve_opened","id":"<sid>","slots":N}       (runner)
//   -> {"cmd":"serve_request","id":"<sid>","rid":"<rid>",...} (forwarded)
//   <- {"event":"telemetry","id":"<sid>","data":{...}}        (runner)
//   -> {"cmd":"serve_close","id":"<sid>"}                     (forwarded)
//   <- {"event":"serve_closed","id":"<sid>","served":N}       (runner)
//   -> {"cmd":"profile_start","id":"<pid>","dir":"...","sid":"<sid>"}
//   <- {"event":"profile_started","id":"<pid>","pid":123}     (runner)
//   -> {"cmd":"profile_stop","id":"<pid>","artifact_dir":"..."}
//   <- {"event":"profile_stopped","id":"<pid>","path":"...",
//       "digest":"<sha256>","bytes":N}                        (runner)
//   <- {"event":"profile_error","id":"<pid>","code":"...",...}
//   -> {"cmd":"epoch","epoch":N}
//   <- {"event":"epoch_ok","epoch":N} | {"event":"error","id":"",
//       "code":"stale_epoch",...}
//   -> {"cmd":"serve_resume","id":"<sid>","rid":"<rid>","from":N} (forwarded)
//   -> {"cmd":"serve_inventory"}
//   <- {"event":"serve_inventory","pid":N,"epoch":N,"sessions":[...]}
//   -> {"cmd":"task_inventory"}
//   <- {"event":"task_inventory","pid":N,"epoch":N,"tasks":[...]}
//   -> {"cmd":"shutdown"}
//   <- {"event":"bye"}
//   <- {"event":"error","message":"..."}  (malformed input, unknown id, ...)
//
// RPC execute-by-digest: register_fn verifies the CAS artifact's sha256
// IN THIS PROCESS before accepting the registration (a torn or stale
// artifact is refused with code digest_mismatch, which the dispatcher
// classifies permanent), and remembers digest -> {path, runner argv}.
// invoke forks the registered runner (the Python harness in --rpc-child
// mode), pipes the invoke command — args inline, nothing staged to disk —
// to its stdin, and streams the runner's started/telemetry/result events
// back over this channel verbatim.  The resident *interpreter* lives in
// the harness pool server; this native path keeps the protocol uniform
// for workers running only the C++ agent (one interpreter start per
// invocation instead of a warm loop — the dispatcher prefers the pool
// runtime for RPC dispatch when both are available).
//
// The watch side-band tails a task's worker-local JSONL telemetry file
// (heartbeats, worker events) back over the channel in near-real-time.  A
// (re-)watch always starts at offset 0 so lines buffered while the channel
// was down are flushed on reconnect; the dispatcher dedups by `seq`.
//
// Children run in their own sessions (setsid + exec), so they survive an
// agent/channel drop exactly like the fallback path's `nohup` launch — the
// executor can always resume supervision by pid-file polling.  stdout is
// line-buffered JSON only; child output goes to the per-task log file, same
// contract as the polling path.
//
// Single file, C++17, no dependencies beyond POSIX; built on the worker by
// the executor's preflight (g++ -O2 -std=c++17 -o agent agent.cc).

#include <cerrno>
#include <cctype>
#include <csignal>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <map>
#include <poll.h>
#include <string>
#include <sys/stat.h>
#include <sys/wait.h>
#include <unistd.h>
#include <vector>

// ---------------------------------------------------------------------------
// Minimal JSON: just the subset this protocol uses (obj/arr/string/int/bool).
// ---------------------------------------------------------------------------

struct Json {
  enum Type { Null, Bool, Int, Str, Arr, Obj } type = Null;
  bool b = false;
  long long i = 0;
  std::string s;
  std::vector<Json> arr;
  std::vector<std::pair<std::string, Json>> obj;

  const Json* get(const std::string& key) const {
    if (type != Obj) return nullptr;
    for (const auto& kv : obj)
      if (kv.first == key) return &kv.second;
    return nullptr;
  }
};

struct JsonParser {
  const char* p;
  const char* end;
  bool ok = true;

  explicit JsonParser(const std::string& text)
      : p(text.data()), end(text.data() + text.size()) {}

  void skip_ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n')) p++;
  }
  bool fail() { ok = false; return false; }

  bool parse_value(Json& out) {
    skip_ws();
    if (p >= end) return fail();
    switch (*p) {
      case '{': return parse_obj(out);
      case '[': return parse_arr(out);
      case '"': out.type = Json::Str; return parse_string(out.s);
      case 't':
        if (end - p >= 4 && !strncmp(p, "true", 4)) {
          out.type = Json::Bool; out.b = true; p += 4; return true;
        }
        return fail();
      case 'f':
        if (end - p >= 5 && !strncmp(p, "false", 5)) {
          out.type = Json::Bool; out.b = false; p += 5; return true;
        }
        return fail();
      case 'n':
        if (end - p >= 4 && !strncmp(p, "null", 4)) {
          out.type = Json::Null; p += 4; return true;
        }
        return fail();
      default: return parse_int(out);
    }
  }

  bool parse_int(Json& out) {
    char* num_end = nullptr;
    errno = 0;
    long long v = strtoll(p, &num_end, 10);
    if (num_end == p || errno == ERANGE) return fail();
    // Skip a fractional/exponent tail (we only ever need integers).
    const char* q = num_end;
    while (q < end && (*q == '.' || *q == 'e' || *q == 'E' || *q == '+' ||
                       *q == '-' || isdigit((unsigned char)*q)))
      q++;
    out.type = Json::Int;
    out.i = v;
    p = q;
    return true;
  }

  bool parse_hex4(unsigned& out) {
    if (end - p < 4) return fail();
    out = 0;
    for (int k = 0; k < 4; k++) {
      char c = p[k];
      out <<= 4;
      if (c >= '0' && c <= '9') out |= (unsigned)(c - '0');
      else if (c >= 'a' && c <= 'f') out |= (unsigned)(c - 'a' + 10);
      else if (c >= 'A' && c <= 'F') out |= (unsigned)(c - 'A' + 10);
      else return fail();
    }
    p += 4;
    return true;
  }

  void append_utf8(std::string& s, unsigned cp) {
    if (cp < 0x80) {
      s += (char)cp;
    } else if (cp < 0x800) {
      s += (char)(0xC0 | (cp >> 6));
      s += (char)(0x80 | (cp & 0x3F));
    } else if (cp < 0x10000) {
      s += (char)(0xE0 | (cp >> 12));
      s += (char)(0x80 | ((cp >> 6) & 0x3F));
      s += (char)(0x80 | (cp & 0x3F));
    } else {
      s += (char)(0xF0 | (cp >> 18));
      s += (char)(0x80 | ((cp >> 12) & 0x3F));
      s += (char)(0x80 | ((cp >> 6) & 0x3F));
      s += (char)(0x80 | (cp & 0x3F));
    }
  }

  bool parse_string(std::string& out) {
    if (*p != '"') return fail();
    p++;
    out.clear();
    while (p < end && *p != '"') {
      if (*p == '\\') {
        p++;
        if (p >= end) return fail();
        switch (*p) {
          case '"': out += '"'; p++; break;
          case '\\': out += '\\'; p++; break;
          case '/': out += '/'; p++; break;
          case 'b': out += '\b'; p++; break;
          case 'f': out += '\f'; p++; break;
          case 'n': out += '\n'; p++; break;
          case 'r': out += '\r'; p++; break;
          case 't': out += '\t'; p++; break;
          case 'u': {
            p++;
            unsigned cp;
            if (!parse_hex4(cp)) return false;
            if (cp >= 0xD800 && cp <= 0xDBFF && end - p >= 6 && p[0] == '\\' &&
                p[1] == 'u') {
              p += 2;
              unsigned lo;
              if (!parse_hex4(lo)) return false;
              cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
            }
            append_utf8(out, cp);
            break;
          }
          default: return fail();
        }
      } else {
        out += *p++;
      }
    }
    if (p >= end) return fail();
    p++;  // closing quote
    return true;
  }

  bool parse_arr(Json& out) {
    out.type = Json::Arr;
    p++;  // '['
    skip_ws();
    if (p < end && *p == ']') { p++; return true; }
    while (true) {
      Json elem;
      if (!parse_value(elem)) return false;
      out.arr.push_back(std::move(elem));
      skip_ws();
      if (p >= end) return fail();
      if (*p == ',') { p++; continue; }
      if (*p == ']') { p++; return true; }
      return fail();
    }
  }

  bool parse_obj(Json& out) {
    out.type = Json::Obj;
    p++;  // '{'
    skip_ws();
    if (p < end && *p == '}') { p++; return true; }
    while (true) {
      skip_ws();
      std::string key;
      if (p >= end || *p != '"' || !parse_string(key)) return fail();
      skip_ws();
      if (p >= end || *p != ':') return fail();
      p++;
      Json val;
      if (!parse_value(val)) return false;
      out.obj.emplace_back(std::move(key), std::move(val));
      skip_ws();
      if (p >= end) return fail();
      if (*p == ',') { p++; continue; }
      if (*p == '}') { p++; return true; }
      return fail();
    }
  }
};

static bool parse_json(const std::string& line, Json& out) {
  JsonParser parser(line);
  if (!parser.parse_value(out)) return false;
  parser.skip_ws();
  return parser.ok && parser.p == parser.end;
}

static std::string json_escape(const std::string& s) {
  std::string out;
  out.reserve(s.size() + 8);
  for (unsigned char c : s) {
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\n': out += "\\n"; break;
      case '\r': out += "\\r"; break;
      case '\t': out += "\\t"; break;
      default:
        if (c < 0x20) {
          char buf[8];
          snprintf(buf, sizeof buf, "\\u%04x", c);
          out += buf;
        } else {
          out += (char)c;
        }
    }
  }
  return out;
}

// ---------------------------------------------------------------------------
// Event emission: stdout is protocol-only, one JSON object per line.
// ---------------------------------------------------------------------------

static void emit(const std::string& line) {
  fputs(line.c_str(), stdout);
  fputc('\n', stdout);
  fflush(stdout);
}

static void emit_error(const std::string& message, const std::string& id = "") {
  std::string line = "{\"event\":\"error\",\"message\":\"" + json_escape(message) + "\"";
  if (!id.empty()) line += ",\"id\":\"" + json_escape(id) + "\"";
  emit(line + "}");
}

// ---------------------------------------------------------------------------
// Binary frame protocol (negotiated; JSONL stays the fallback).
//
// Wire layout (mirrors harness.py and transport/frames.py — the three are
// kept byte-compatible by tests/test_frames.py):
//
//   magic(2)=C5 F7  version(1)  verb(1)  flags(1)  hlen(4 BE)  blen(4 BE)
//   header: UTF-8 JSON object   body: raw bytes
//
// This agent holds no Python runtime, so it never encodes or decodes frame
// BODIES: inbound invoke/serve frames forward VERBATIM into the runner
// children (which parse frames natively), and runner output frames —
// binary results, coalesced token batches — pass through the stream pump
// verbatim upstream.  The agent itself only reads frame HEADERS (plain
// JSON) to route by session/registration, plus emits header-only frames
// for its own watch side-band batches.  Negotiation rides the ready
// banner: `"frames":1` advertised, client answers `{"cmd":"frames"}`, ack
// flips the mode; the COVALENT_TPU_AGENT_FRAMES=0 env kill switch keeps
// the agent JSONL-only.  No "codecs" are advertised, so clients never
// compress bodies toward a native agent.
// ---------------------------------------------------------------------------

static const unsigned char kFrameMagic0 = 0xC5;
static const unsigned char kFrameMagic1 = 0xF7;
static const unsigned char kFrameVersion = 1;
static const size_t kFrameHeaderLen = 13;
static const uint64_t kFrameMaxHeader = 16ull * 1024 * 1024;
static const uint64_t kFrameMaxBody = 512ull * 1024 * 1024;
static const uint8_t kVerbTelemetry = 3;

static bool g_frames = false;

static bool frames_env_enabled() {
  const char* env = getenv("COVALENT_TPU_AGENT_FRAMES");
  if (!env) return true;
  std::string v(env);
  return !(v == "0" || v == "off" || v == "false" || v == "no");
}

static uint32_t read_be32(const char* p) {
  return ((uint32_t)(unsigned char)p[0] << 24) |
         ((uint32_t)(unsigned char)p[1] << 16) |
         ((uint32_t)(unsigned char)p[2] << 8) |
         (uint32_t)(unsigned char)p[3];
}

static void emit_raw(const std::string& bytes) {
  fwrite(bytes.data(), 1, bytes.size(), stdout);
  fflush(stdout);
}

static void emit_frame(uint8_t verb, const std::string& header,
                       const std::string& body) {
  unsigned char h[kFrameHeaderLen];
  h[0] = kFrameMagic0; h[1] = kFrameMagic1;
  h[2] = kFrameVersion; h[3] = verb; h[4] = 0;
  uint32_t hl = (uint32_t)header.size(), bl = (uint32_t)body.size();
  h[5] = (unsigned char)(hl >> 24); h[6] = (unsigned char)(hl >> 16);
  h[7] = (unsigned char)(hl >> 8);  h[8] = (unsigned char)hl;
  h[9] = (unsigned char)(bl >> 24); h[10] = (unsigned char)(bl >> 16);
  h[11] = (unsigned char)(bl >> 8); h[12] = (unsigned char)bl;
  fwrite(h, 1, sizeof h, stdout);
  fwrite(header.data(), 1, header.size(), stdout);
  if (!body.empty()) fwrite(body.data(), 1, body.size(), stdout);
  fflush(stdout);
}

// After a bad magic/version/length the stream position is untrusted; the
// next newline is the only honest resync point (valid traffic is
// self-delimiting frames or newline-terminated JSON).
static void frame_resync(std::string& buffer) {
  size_t nl = buffer.find('\n', 1);
  if (nl == std::string::npos) buffer.clear();
  else buffer.erase(0, nl + 1);
}

// ---------------------------------------------------------------------------
// SHA-256 (FIPS 180-4): register_fn digest verification, no dependencies.
// ---------------------------------------------------------------------------

struct Sha256 {
  uint32_t state[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                       0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
  uint64_t bitlen = 0;
  unsigned char block[64];
  size_t blocklen = 0;

  static uint32_t rotr(uint32_t x, unsigned n) {
    return (x >> n) | (x << (32 - n));
  }

  void transform(const unsigned char* p) {
    static const uint32_t k[64] = {
        0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b,
        0x59f111f1, 0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01,
        0x243185be, 0x550c7dc3, 0x72be5d74, 0x80deb1fe, 0x9bdc06a7,
        0xc19bf174, 0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
        0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da, 0x983e5152,
        0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
        0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc,
        0x53380d13, 0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
        0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3, 0xd192e819,
        0xd6990624, 0xf40e3585, 0x106aa070, 0x19a4c116, 0x1e376c08,
        0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f,
        0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
        0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};
    uint32_t m[64];
    for (int i = 0; i < 16; i++)
      m[i] = (uint32_t)p[i * 4] << 24 | (uint32_t)p[i * 4 + 1] << 16 |
             (uint32_t)p[i * 4 + 2] << 8 | (uint32_t)p[i * 4 + 3];
    for (int i = 16; i < 64; i++) {
      uint32_t s0 = rotr(m[i - 15], 7) ^ rotr(m[i - 15], 18) ^ (m[i - 15] >> 3);
      uint32_t s1 = rotr(m[i - 2], 17) ^ rotr(m[i - 2], 19) ^ (m[i - 2] >> 10);
      m[i] = m[i - 16] + s0 + m[i - 7] + s1;
    }
    uint32_t a = state[0], b = state[1], c = state[2], d = state[3];
    uint32_t e = state[4], f = state[5], g = state[6], h = state[7];
    for (int i = 0; i < 64; i++) {
      uint32_t s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      uint32_t ch = (e & f) ^ (~e & g);
      uint32_t t1 = h + s1 + ch + k[i] + m[i];
      uint32_t s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
      uint32_t t2 = s0 + maj;
      h = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    state[0] += a; state[1] += b; state[2] += c; state[3] += d;
    state[4] += e; state[5] += f; state[6] += g; state[7] += h;
  }

  void update(const unsigned char* p, size_t len) {
    bitlen += (uint64_t)len * 8;
    while (len > 0) {
      size_t take = 64 - blocklen;
      if (take > len) take = len;
      memcpy(block + blocklen, p, take);
      blocklen += take;
      p += take;
      len -= take;
      if (blocklen == 64) {
        transform(block);
        blocklen = 0;
      }
    }
  }

  std::string hex_digest() {
    block[blocklen++] = 0x80;
    if (blocklen > 56) {
      while (blocklen < 64) block[blocklen++] = 0;
      transform(block);
      blocklen = 0;
    }
    while (blocklen < 56) block[blocklen++] = 0;
    for (int i = 7; i >= 0; i--) block[blocklen++] = (unsigned char)(bitlen >> (i * 8));
    transform(block);
    static const char* hexd = "0123456789abcdef";
    std::string out;
    out.reserve(64);
    for (uint32_t word : state) {
      for (int shift = 28; shift >= 0; shift -= 4)
        out += hexd[(word >> shift) & 0xF];
    }
    return out;
  }
};

static bool sha256_file(const std::string& path, std::string& hex_out) {
  int fd = open(path.c_str(), O_RDONLY);
  if (fd < 0) return false;
  Sha256 sha;
  char chunk[65536];
  ssize_t n;
  while ((n = read(fd, chunk, sizeof chunk)) > 0)
    sha.update((const unsigned char*)chunk, (size_t)n);
  bool ok = (n == 0);
  close(fd);
  if (!ok) return false;
  hex_out = sha.hex_digest();
  return true;
}

// ---------------------------------------------------------------------------
// Child management.
// ---------------------------------------------------------------------------

static int g_sigchld_pipe[2] = {-1, -1};

static void on_sigchld(int) {
  // Self-pipe trick: make SIGCHLD poll()-able without signalfd.
  ssize_t ignored = write(g_sigchld_pipe[1], "x", 1);
  (void)ignored;
}

struct Task {
  pid_t pid;
  std::string id;
};

static std::map<pid_t, Task> g_tasks;

static void spawn(const Json& cmd) {
  const Json* id_field = cmd.get("id");
  const Json* argv_field = cmd.get("argv");
  if (!id_field || id_field->type != Json::Str || !argv_field ||
      argv_field->type != Json::Arr || argv_field->arr.empty()) {
    emit_error("run requires string id and non-empty argv array");
    return;
  }
  const std::string& id = id_field->s;
  const Json* cwd = cmd.get("cwd");
  const Json* env = cmd.get("env");
  const Json* log = cmd.get("log");

  pid_t pid = fork();
  if (pid < 0) {
    emit_error(std::string("fork failed: ") + strerror(errno), id);
    return;
  }
  if (pid == 0) {
    // Child: own session so it survives an agent/channel drop, exactly like
    // the polling path's nohup+setsid launch.
    setsid();
    if (cwd && cwd->type == Json::Str && !cwd->s.empty()) {
      if (chdir(cwd->s.c_str()) != 0) _exit(127);
    }
    if (env && env->type == Json::Obj) {
      for (const auto& kv : env->obj)
        if (kv.second.type == Json::Str)
          setenv(kv.first.c_str(), kv.second.s.c_str(), 1);
    }
    int log_fd = -1;
    if (log && log->type == Json::Str && !log->s.empty()) {
      log_fd = open(log->s.c_str(), O_WRONLY | O_CREAT | O_APPEND, 0644);
    }
    if (log_fd < 0) log_fd = open("/dev/null", O_WRONLY);
    int devnull = open("/dev/null", O_RDONLY);
    if (devnull >= 0) dup2(devnull, 0);
    if (log_fd >= 0) {
      dup2(log_fd, 1);
      dup2(log_fd, 2);
    }
    for (int fd = 3; fd < 256; fd++) close(fd);

    std::vector<char*> argv;
    argv.reserve(argv_field->arr.size() + 1);
    for (const auto& a : argv_field->arr)
      if (a.type == Json::Str) argv.push_back(const_cast<char*>(a.s.c_str()));
    argv.push_back(nullptr);
    execvp(argv[0], argv.data());
    _exit(127);
  }
  g_tasks[pid] = Task{pid, id};
  emit("{\"event\":\"started\",\"id\":\"" + json_escape(id) +
       "\",\"pid\":" + std::to_string((long long)pid) + "}");
}

static void kill_task(const Json& cmd) {
  const Json* id_field = cmd.get("id");
  if (!id_field || id_field->type != Json::Str) {
    emit_error("kill requires string id");
    return;
  }
  const Json* sig_field = cmd.get("sig");
  int sig = (sig_field && sig_field->type == Json::Int) ? (int)sig_field->i : SIGTERM;
  for (const auto& kv : g_tasks) {
    if (kv.second.id == id_field->s) {
      // Negative pid: the whole session/process group the child leads.
      kill(-kv.second.pid, sig);
      kill(kv.second.pid, sig);
      emit("{\"event\":\"killed\",\"id\":\"" + json_escape(id_field->s) + "\"}");
      return;
    }
  }
  emit_error("unknown task id", id_field->s);
}

// ---------------------------------------------------------------------------
// RPC execute-by-digest: registry + runner-forked invocations.
// ---------------------------------------------------------------------------

struct Registration {
  std::string path;                 // CAS artifact holding the function
  std::vector<std::string> runner;  // argv forked per invocation
};

static std::map<std::string, Registration> g_registry;

struct RpcStream {
  std::string id;
  std::string buf;
};

//: runner-stdout fd -> stream state; lines are forwarded verbatim.
static std::map<int, RpcStream> g_rpc_streams;

static void register_fn(const Json& cmd) {
  const Json* digest = cmd.get("digest");
  const Json* path = cmd.get("path");
  if (!digest || digest->type != Json::Str || !path ||
      path->type != Json::Str || path->s.empty()) {
    emit_error("register_fn requires digest and path");
    return;
  }
  Registration reg;
  reg.path = path->s;
  const Json* runner = cmd.get("runner");
  if (runner && runner->type == Json::Arr)
    for (const auto& part : runner->arr)
      if (part.type == Json::Str) reg.runner.push_back(part.s);
  std::string hex;
  if (!sha256_file(reg.path, hex)) {
    emit("{\"event\":\"register_error\",\"digest\":\"" +
         json_escape(digest->s) + "\",\"code\":\"missing\",\"message\":\"" +
         json_escape("cannot read " + reg.path) + "\"}");
    return;
  }
  if (hex != digest->s) {
    // Refused, never stored: invoking a payload whose bytes don't match
    // their content address would execute the wrong function.  The
    // dispatcher classifies this permanent (torn or stale CAS artifact).
    emit("{\"event\":\"register_error\",\"digest\":\"" +
         json_escape(digest->s) +
         "\",\"code\":\"digest_mismatch\",\"message\":\"" +
         json_escape(reg.path + " does not match its content digest") +
         "\"}");
    return;
  }
  g_registry[digest->s] = std::move(reg);
  emit("{\"event\":\"registered\",\"digest\":\"" + json_escape(digest->s) +
       "\"}");
}

// `payload` is the exact byte sequence piped to the runner child: the
// invoke line + "\n" on the JSONL path, or the raw invoke FRAME verbatim
// on the negotiated binary path (the Python runner parses both).  With
// frames negotiated, a frames-enable line precedes it so the runner's own
// result events come back framed and pass through the pump untouched.
static void invoke_task(const Json& cmd, const std::string& payload) {
  const Json* id_field = cmd.get("id");
  const Json* digest = cmd.get("digest");
  if (!id_field || id_field->type != Json::Str || !digest ||
      digest->type != Json::Str) {
    emit_error("invoke requires string id and digest");
    return;
  }
  auto it = g_registry.find(digest->s);
  if (it == g_registry.end()) {
    emit("{\"event\":\"error\",\"id\":\"" + json_escape(id_field->s) +
         "\",\"code\":\"unregistered\",\"message\":\"no registered function "
         "for digest\"}");
    return;
  }
  if (it->second.runner.empty()) {
    emit("{\"event\":\"error\",\"id\":\"" + json_escape(id_field->s) +
         "\",\"code\":\"no_runner\",\"message\":\"registration carried no "
         "runner argv\"}");
    return;
  }
  int in_pipe[2] = {-1, -1}, out_pipe[2] = {-1, -1};
  if (pipe(in_pipe) != 0 || pipe(out_pipe) != 0) {
    if (in_pipe[0] >= 0) { close(in_pipe[0]); close(in_pipe[1]); }
    emit_error(std::string("pipe failed: ") + strerror(errno), id_field->s);
    return;
  }
  pid_t pid = fork();
  if (pid < 0) {
    close(in_pipe[0]); close(in_pipe[1]);
    close(out_pipe[0]); close(out_pipe[1]);
    emit_error(std::string("fork failed: ") + strerror(errno), id_field->s);
    return;
  }
  if (pid == 0) {
    // Runner child: own session (kill -- -pid reaches it), invoke command
    // on stdin, protocol events on stdout, stderr discarded.
    setsid();
    dup2(in_pipe[0], 0);
    dup2(out_pipe[1], 1);
    int devnull = open("/dev/null", O_WRONLY);
    if (devnull >= 0) dup2(devnull, 2);
    for (int fd = 3; fd < 256; fd++) close(fd);
    std::vector<char*> argv;
    argv.reserve(it->second.runner.size() + 1);
    for (const auto& a : it->second.runner)
      argv.push_back(const_cast<char*>(a.c_str()));
    argv.push_back(nullptr);
    execvp(argv[0], argv.data());
    _exit(127);
  }
  close(in_pipe[0]);
  close(out_pipe[1]);
  // Feed the invoke command — it carries the CAS path and inline args, so
  // the runner needs no disk staging — then close: exactly one command.
  std::string full = g_frames
      ? std::string("{\"cmd\":\"frames\",\"version\":1}\n") + payload
      : payload;
  size_t off = 0;
  while (off < full.size()) {
    ssize_t n = write(in_pipe[1], full.data() + off, full.size() - off);
    if (n <= 0) break;
    off += (size_t)n;
  }
  close(in_pipe[1]);
  g_tasks[pid] = Task{pid, id_field->s};
  g_rpc_streams[out_pipe[0]] = RpcStream{id_field->s, ""};
  // No `started` from here: the runner emits its own, with the pid that
  // actually executes the function.
}

// ---------------------------------------------------------------------------
// Serving sessions: a resident runner child per session, stdin held open.
//
// Unlike invoke (one command, pipe closed, child exits after one result), a
// session lives for many requests: serve_open forks the provided runner argv
// (the Python harness in --serve-child mode) with its stdin pipe KEPT OPEN,
// and every later serve_request/serve_close line for that sid is forwarded
// verbatim.  The child's stdout rides the same validated pump as RPC
// runners, so serve_opened / telemetry / serve_closed events flow back
// unchanged.  The resident *model* lives in the child; this agent only
// switches lines.
// ---------------------------------------------------------------------------

struct ServeChild {
  pid_t pid;
  int stdin_fd;
};

static std::map<std::string, ServeChild> g_serve_children;

static bool write_all(int fd, const std::string& payload) {
  size_t off = 0;
  while (off < payload.size()) {
    ssize_t n = write(fd, payload.data() + off, payload.size() - off);
    if (n <= 0) return false;
    off += (size_t)n;
  }
  return true;
}

// A serve_open refusal must arrive as serve_error (never a generic
// "error"): the client's open waiter settles only on serve_opened /
// serve_error, so anything else stalls it for the full open timeout.
static void emit_serve_error(const std::string& sid, const std::string& code,
                             const std::string& message, bool permanent) {
  emit("{\"event\":\"serve_error\",\"id\":\"" + json_escape(sid) +
       "\",\"code\":\"" + json_escape(code) + "\",\"message\":\"" +
       json_escape(message) + "\"" +
       (permanent ? ",\"permanent\":true" : "") + "}");
}

static void serve_open(const Json& cmd, const std::string& raw_line) {
  const Json* id_field = cmd.get("id");
  const Json* runner = cmd.get("runner");
  if (!id_field || id_field->type != Json::Str || !runner ||
      runner->type != Json::Arr || runner->arr.empty()) {
    emit_serve_error(
        id_field && id_field->type == Json::Str ? id_field->s : "",
        "bad_request",
        "serve_open requires string id and non-empty runner argv", true);
    return;
  }
  const std::string& sid = id_field->s;
  if (g_serve_children.count(sid)) {
    emit("{\"event\":\"serve_error\",\"id\":\"" + json_escape(sid) +
         "\",\"code\":\"duplicate\",\"message\":\"session already open\","
         "\"permanent\":true}");
    return;
  }
  int in_pipe[2] = {-1, -1}, out_pipe[2] = {-1, -1};
  if (pipe(in_pipe) != 0 || pipe(out_pipe) != 0) {
    if (in_pipe[0] >= 0) { close(in_pipe[0]); close(in_pipe[1]); }
    emit_serve_error(sid, "spawn_failed",
                     std::string("pipe failed: ") + strerror(errno), false);
    return;
  }
  pid_t pid = fork();
  if (pid < 0) {
    close(in_pipe[0]); close(in_pipe[1]);
    close(out_pipe[0]); close(out_pipe[1]);
    emit_serve_error(sid, "spawn_failed",
                     std::string("fork failed: ") + strerror(errno), false);
    return;
  }
  if (pid == 0) {
    setsid();
    dup2(in_pipe[0], 0);
    dup2(out_pipe[1], 1);
    int devnull = open("/dev/null", O_WRONLY);
    if (devnull >= 0) dup2(devnull, 2);
    for (int fd = 3; fd < 256; fd++) close(fd);
    std::vector<char*> argv;
    argv.reserve(runner->arr.size() + 1);
    for (const auto& a : runner->arr)
      if (a.type == Json::Str) argv.push_back(const_cast<char*>(a.s.c_str()));
    argv.push_back(nullptr);
    execvp(argv[0], argv.data());
    _exit(127);
  }
  close(in_pipe[0]);
  close(out_pipe[1]);
  // The serve_open line itself is the child's first command (it carries
  // the CAS path + options); the pipe stays open for the session's life.
  // With frames negotiated upstream, a frames-enable line goes first so
  // the child's token stream comes back as coalesced binary frames.
  std::string first = g_frames
      ? std::string("{\"cmd\":\"frames\",\"version\":1}\n") + raw_line + "\n"
      : raw_line + "\n";
  if (!write_all(in_pipe[1], first)) {
    // Child unreachable at birth: fail the open (transient — a fresh
    // gang can retry), close both pipe ends so the child EOFs out, and
    // register ONLY the pid (the reaper needs it) — a session entry
    // holding this closed fd would make a later serve_request write
    // into whatever descriptor the number gets reused for.
    close(in_pipe[1]);
    close(out_pipe[0]);
    g_tasks[pid] = Task{pid, sid};
    emit_serve_error(sid, "spawn_failed",
                     "serve runner rejected its open command", false);
    return;
  }
  g_tasks[pid] = Task{pid, sid};
  g_serve_children[sid] = ServeChild{pid, in_pipe[1]};
  g_rpc_streams[out_pipe[0]] = RpcStream{sid, ""};
  // serve_opened (or serve_error) comes from the runner once the model
  // factory settles — nothing synthesized here.
}

// `payload` is the exact byte sequence forwarded to the session child —
// a command line + "\n", or a raw binary frame verbatim (the --serve-child
// loop parses both off one stream).
static void serve_forward(const Json& cmd, const std::string& payload,
                          bool is_close) {
  const Json* id_field = cmd.get("id");
  const std::string sid =
      (id_field && id_field->type == Json::Str) ? id_field->s : "";
  auto it = g_serve_children.find(sid);
  if (it == g_serve_children.end()) {
    if (is_close) {
      emit("{\"event\":\"serve_error\",\"id\":\"" + json_escape(sid) +
           "\",\"code\":\"unknown_session\",\"message\":\"no open session\","
           "\"permanent\":true}");
    } else {
      // Per-request reject, streamed like the pool server's: the caller's
      // stream for this rid must fail fast, not hang.
      const Json* rid = cmd.get("rid");
      emit("{\"event\":\"telemetry\",\"id\":\"" + json_escape(sid) +
           "\",\"data\":{\"type\":\"serve.reject\",\"rid\":\"" +
           json_escape(rid && rid->type == Json::Str ? rid->s : "") +
           "\",\"code\":\"unknown_session\",\"message\":\"no open "
           "session\"}}");
    }
    return;
  }
  bool ok = write_all(it->second.stdin_fd, payload);
  if (is_close || !ok) {
    // Close (or a torn pipe): EOF the child's stdin; it drains admitted
    // lanes, emits serve_closed, and exits — the reaper cleans the maps.
    close(it->second.stdin_fd);
    g_serve_children.erase(it);
  }
}

// serve_prefill forwards like serve_request, but its waiter settles on
// serve_kv events only — an unknown session must answer with a serve_kv
// error (not a streamed serve.reject) or the dispatcher's prefill call
// sits out its whole timeout before degrading to a full prefill.
static void serve_prefill_forward(const Json& cmd,
                                  const std::string& payload) {
  const Json* id_field = cmd.get("id");
  const std::string sid =
      (id_field && id_field->type == Json::Str) ? id_field->s : "";
  auto it = g_serve_children.find(sid);
  if (it == g_serve_children.end()) {
    const Json* rid = cmd.get("rid");
    emit("{\"event\":\"serve_kv\",\"id\":\"" + json_escape(sid) +
         "\",\"rid\":\"" +
         json_escape(rid && rid->type == Json::Str ? rid->s : "") +
         "\",\"code\":\"unknown_session\",\"message\":\"no open "
         "session\"}");
    return;
  }
  if (!write_all(it->second.stdin_fd, payload)) {
    close(it->second.stdin_fd);
    g_serve_children.erase(it);
    // A torn pipe means no serve_kv will ever come from the child: the
    // waiter must fail NOW (and degrade to full prefill), not sit out
    // its whole timeout — same rationale as the unknown-session branch.
    const Json* rid = cmd.get("rid");
    emit("{\"event\":\"serve_kv\",\"id\":\"" + json_escape(sid) +
         "\",\"rid\":\"" +
         json_escape(rid && rid->type == Json::Str ? rid->s : "") +
         "\",\"code\":\"runner_exited\",\"message\":\"serve runner pipe "
         "broken\"}");
  }
}

// serve_attach / serve_detach waiters settle on serve_attached /
// serve_detached events keyed (id, adapter) — an unknown session or a
// torn pipe must answer in that shape immediately, same rationale as
// serve_prefill_forward above.
static void serve_attach_forward(const Json& cmd, const std::string& name,
                                 const std::string& payload) {
  const Json* id_field = cmd.get("id");
  const std::string sid =
      (id_field && id_field->type == Json::Str) ? id_field->s : "";
  const Json* a = cmd.get("adapter");
  const std::string adapter =
      (a && a->type == Json::Str) ? a->s : "";
  auto it = g_serve_children.find(sid);
  if (it == g_serve_children.end()) {
    emit("{\"event\":\"" + name + "ed\",\"id\":\"" + json_escape(sid) +
         "\",\"adapter\":\"" + json_escape(adapter) +
         "\",\"code\":\"unknown_session\",\"message\":\"no open session\","
         "\"permanent\":true}");
    return;
  }
  if (!write_all(it->second.stdin_fd, payload)) {
    close(it->second.stdin_fd);
    g_serve_children.erase(it);
    emit("{\"event\":\"" + name + "ed\",\"id\":\"" + json_escape(sid) +
         "\",\"adapter\":\"" + json_escape(adapter) +
         "\",\"code\":\"runner_exited\",\"message\":\"serve runner pipe "
         "broken\"}");
  }
}

// Resident-mode profiling: the native agent holds no Python runtime of
// its own — the resident state worth profiling lives in its serve-child
// session runners.  profile_start/profile_stop forward verbatim into a live
// session child ("sid" pins which one; otherwise any), whose --serve-child
// loop drives torch.profiler and answers profile_started / profile_stopped /
// profile_error back over the same stream pump.  With no live session there
// is nothing to profile: refuse fast so the client's waiter doesn't sit out
// its whole timeout.  The start's target is remembered per profile id so a
// sid-less stop lands on the SAME child — begin() can change between the
// two commands (a new session sorting earlier), and routing the stop
// elsewhere would orphan an active trace in the original child forever.

//: profile id -> sid of the serve child that received its profile_start.
static std::map<std::string, std::string> g_profile_targets;

static void profile_forward(const Json& cmd, const std::string& raw_line,
                            bool is_stop) {
  const Json* id_field = cmd.get("id");
  const std::string profile_id =
      (id_field && id_field->type == Json::Str) ? id_field->s : "";
  const Json* sid_field = cmd.get("sid");
  std::string sid =
      (sid_field && sid_field->type == Json::Str) ? sid_field->s : "";
  if (sid.empty() && is_stop) {
    auto route = g_profile_targets.find(profile_id);
    if (route != g_profile_targets.end()) sid = route->second;
  }
  auto it = sid.empty() ? g_serve_children.begin()
                        : g_serve_children.find(sid);
  if (it == g_serve_children.end()) {
    g_profile_targets.erase(profile_id);
    emit("{\"event\":\"profile_error\",\"id\":\"" + json_escape(profile_id) +
         "\",\"code\":\"unavailable\",\"message\":\"no live serving session "
         "to profile\"}");
    return;
  }
  if (!write_all(it->second.stdin_fd, raw_line + "\n")) {
    close(it->second.stdin_fd);
    g_serve_children.erase(it);
    g_profile_targets.erase(profile_id);
    emit("{\"event\":\"profile_error\",\"id\":\"" + json_escape(profile_id) +
         "\",\"code\":\"unavailable\",\"message\":\"session runner pipe "
         "broken\"}");
    return;
  }
  // The route lives until the child answers terminally (profile_stopped,
  // or any profile_error except the retryable stop_failed) — erasing at
  // stop-forward time would send a RETRIED stop after a stop_failed to
  // begin()'s child instead of the one still holding the active trace.
  // Terminal cleanup happens in pump_rpc_stream; dead children reap
  // their routes in reap_serve_child.
  if (!is_stop) g_profile_targets[profile_id] = it->first;
}

static void reap_serve_child(pid_t pid) {
  for (auto it = g_serve_children.begin(); it != g_serve_children.end(); ++it) {
    if (it->second.pid == pid) {
      // Still registered at death = the child exited WITHOUT a clean
      // serve_close (exec failure before serve_opened, a crash
      // mid-session).  Announce it so a pending open waiter fails fast
      // (transient — a fresh gang can retry) instead of sitting out the
      // whole open timeout on a runner that already _exit(127)ed.
      emit_serve_error(it->first, "runner_exited",
                       "serve runner exited without closing its session",
                       false);
      close(it->second.stdin_fd);
      // Any in-flight profile routed at this child died with it.
      for (auto route = g_profile_targets.begin();
           route != g_profile_targets.end();) {
        if (route->second == it->first) route = g_profile_targets.erase(route);
        else ++route;
      }
      g_serve_children.erase(it);
      return;
    }
  }
}

static void pump_rpc_stream(int fd) {
  auto it = g_rpc_streams.find(fd);
  if (it == g_rpc_streams.end()) return;
  char chunk[65536];
  ssize_t n = read(fd, chunk, sizeof chunk);
  if (n <= 0) {
    close(fd);
    g_rpc_streams.erase(it);
    return;
  }
  RpcStream& s = it->second;
  s.buf.append(chunk, (size_t)n);
  while (!s.buf.empty()) {
    if ((unsigned char)s.buf[0] == kFrameMagic0) {
      // Runner-emitted binary frame (framed result, coalesced token
      // batch): forward VERBATIM — this agent never decodes bodies.
      if (s.buf.size() < kFrameHeaderLen) break;
      if ((unsigned char)s.buf[1] != kFrameMagic1 ||
          (unsigned char)s.buf[2] != kFrameVersion) {
        // Corrupt child output must never desync the upstream channel.
        frame_resync(s.buf);
        continue;
      }
      uint64_t hl = read_be32(s.buf.data() + 5);
      uint64_t bl = read_be32(s.buf.data() + 9);
      if (hl > kFrameMaxHeader || bl > kFrameMaxBody) {
        frame_resync(s.buf);
        continue;
      }
      uint64_t total = kFrameHeaderLen + hl + bl;
      if (s.buf.size() < total) break;
      emit_raw(s.buf.substr(0, (size_t)total));
      s.buf.erase(0, (size_t)total);
      continue;
    }
    size_t nl = s.buf.find('\n');
    if (nl == std::string::npos) break;
    std::string line = s.buf.substr(0, nl);
    s.buf.erase(0, nl + 1);
    if (line.empty()) continue;
    Json parsed;
    // Validate before forwarding; valid runner lines ARE protocol events
    // (started/telemetry/result) and pass through verbatim.
    if (!parse_json(line, parsed) || parsed.type != Json::Obj) continue;
    // Profile route lifecycle: a terminal answer retires the profile
    // id -> serve child mapping profile_forward remembered.  stop_failed
    // keeps it — the trace is still active in THAT child and a retried
    // sid-less stop must land there.
    const Json* ev = parsed.get("event");
    if (ev && ev->type == Json::Str &&
        (ev->s == "profile_stopped" || ev->s == "profile_error")) {
      const Json* code = parsed.get("code");
      const bool retryable = ev->s == "profile_error" && code &&
                             code->type == Json::Str &&
                             code->s == "stop_failed";
      const Json* pid_field = parsed.get("id");
      if (!retryable && pid_field && pid_field->type == Json::Str)
        g_profile_targets.erase(pid_field->s);
    }
    emit(line);
  }
}

// ---------------------------------------------------------------------------
// Telemetry side-band: tail watched JSONL files back over the channel.
// ---------------------------------------------------------------------------

struct Watcher {
  std::string path;
  off_t pos = 0;
  std::string buf;
};

static std::map<std::string, Watcher> g_watchers;

static void watch_task(const Json& cmd) {
  const Json* id_field = cmd.get("id");
  const Json* path_field = cmd.get("path");
  if (!id_field || id_field->type != Json::Str || !path_field ||
      path_field->type != Json::Str || path_field->s.empty()) {
    emit_error("watch requires string id and path");
    return;
  }
  // Offset 0 on every (re-)watch: reconnect flushes the buffered backlog.
  Watcher w;
  w.path = path_field->s;
  g_watchers[id_field->s] = std::move(w);
  emit("{\"event\":\"watching\",\"id\":\"" + json_escape(id_field->s) + "\"}");
}

static void unwatch_task(const Json& cmd) {
  const Json* id_field = cmd.get("id");
  if (!id_field || id_field->type != Json::Str) {
    emit_error("unwatch requires string id");
    return;
  }
  g_watchers.erase(id_field->s);
  emit("{\"event\":\"unwatched\",\"id\":\"" + json_escape(id_field->s) + "\"}");
}

static void pump_watchers() {
  for (auto& kv : g_watchers) {
    Watcher& w = kv.second;
    struct stat st;
    if (stat(w.path.c_str(), &st) != 0) continue;  // not written yet
    if (st.st_size < w.pos) {  // truncated/rotated: start over
      w.pos = 0;
      w.buf.clear();
    }
    if (st.st_size == w.pos) continue;
    int fd = open(w.path.c_str(), O_RDONLY);
    if (fd < 0) continue;
    if (lseek(fd, w.pos, SEEK_SET) >= 0) {
      // One bounded read per pump: a telemetry burst must not starve the
      // command loop.
      char chunk[65536];
      ssize_t n = read(fd, chunk, sizeof chunk);
      if (n > 0) {
        w.pos += n;
        w.buf.append(chunk, (size_t)n);
      }
    }
    close(fd);
    size_t nl;
    std::vector<std::string> records;
    while ((nl = w.buf.find('\n')) != std::string::npos) {
      std::string line = w.buf.substr(0, nl);
      w.buf.erase(0, nl + 1);
      if (line.empty()) continue;
      Json parsed;
      // Validate before forwarding; a valid line embeds verbatim as the
      // data object (it is already JSON).
      if (!parse_json(line, parsed) || parsed.type != Json::Obj) continue;
      records.push_back(line);
    }
    if (records.empty()) continue;
    if (g_frames) {
      // One telemetry_batch frame per pump per task: a heartbeat/event
      // burst costs one write upstream, not one per line.  The body is
      // the JSON array of the validated records.
      std::string body = "[";
      for (size_t r = 0; r < records.size(); r++) {
        if (r) body += ",";
        body += records[r];
      }
      body += "]";
      emit_frame(kVerbTelemetry,
                 "{\"event\":\"telemetry_batch\",\"id\":\"" +
                     json_escape(kv.first) + "\",\"count\":" +
                     std::to_string(records.size()) +
                     ",\"_body\":\"records\"}",
                 body);
    } else {
      for (const auto& line : records)
        emit("{\"event\":\"telemetry\",\"id\":\"" + json_escape(kv.first) +
             "\",\"data\":" + line + "}");
    }
  }
}

static void reap_children() {
  while (true) {
    int status = 0;
    pid_t pid = waitpid(-1, &status, WNOHANG);
    if (pid <= 0) break;
    reap_serve_child(pid);
    auto it = g_tasks.find(pid);
    if (it == g_tasks.end()) continue;
    int code = WIFEXITED(status) ? WEXITSTATUS(status) : -1;
    int sig = WIFSIGNALED(status) ? WTERMSIG(status) : 0;
    if (g_watchers.count(it->second.id)) {
      // Auto-unwatch on exit, after one final pump so the tail of the
      // telemetry file is flushed ahead of the exit event: a long-lived
      // agent must not keep stat()ing files of finished tasks forever.
      pump_watchers();
      g_watchers.erase(it->second.id);
    }
    emit("{\"event\":\"exit\",\"id\":\"" + json_escape(it->second.id) +
         "\",\"code\":" + std::to_string(code) +
         ",\"signal\":" + std::to_string(sig) + "}");
    g_tasks.erase(it);
  }
}

// ---------------------------------------------------------------------------
// Dispatcher epoch fencing + crash-recovery inventories.
//
// Mirrors the pool server's contract (harness.py `_EPOCH`/`_FENCED_CMDS`):
// the worker remembers the highest journal epoch any dispatcher ever
// declared and refuses mutating commands from a channel that declared a
// lower one.  This agent's process dies with its channel (EOF ends the
// pump; orphan mode lives in the Python pool server), so the fence here
// exists for protocol parity and for the degenerate zombie case — a
// channel re-declaring an older epoch after a newer one was seen.
// Inventories are read-only and stay open to any dispatcher: a stale one
// can look, not touch.
// ---------------------------------------------------------------------------

static long long g_epoch_max = 0;
static long long g_epoch_channel = 0;

static void handle_epoch(const Json& cmd) {
  const Json* e = cmd.get("epoch");
  long long declared = (e && e->type == Json::Int) ? e->i : 0;
  g_epoch_channel = declared;
  if (declared >= g_epoch_max) {
    g_epoch_max = declared;
    emit("{\"event\":\"epoch_ok\",\"epoch\":" + std::to_string(declared) +
         "}");
  } else {
    emit("{\"event\":\"error\",\"id\":\"\",\"code\":\"stale_epoch\","
         "\"message\":\"dispatcher epoch " + std::to_string(declared) +
         " is stale (worker has seen " + std::to_string(g_epoch_max) +
         ")\"}");
  }
}

static bool is_fenced_cmd(const std::string& n) {
  return n == "run" || n == "register_fn" || n == "invoke" ||
         n == "serve_open" || n == "serve_request" ||
         n == "serve_prefill" || n == "serve_close" ||
         n == "serve_resume" || n == "serve_cancel" ||
         n == "serve_attach" || n == "serve_detach" || n == "kill";
}

// Refuse a fenced command from a stale channel, in the SHAPE the caller's
// waiter settles on (a generic error would stall a serve_open waiter for
// its whole timeout).  Returns true when the command was consumed.
static bool fence_refuse(const std::string& name, const Json& cmd) {
  if (g_epoch_channel >= g_epoch_max || !is_fenced_cmd(name)) return false;
  const Json* id_field = cmd.get("id");
  const std::string id =
      (id_field && id_field->type == Json::Str) ? id_field->s : "";
  const Json* rid_field = cmd.get("rid");
  const std::string rid =
      (rid_field && rid_field->type == Json::Str) ? rid_field->s : "";
  const std::string message =
      "dispatcher epoch " + std::to_string(g_epoch_channel) +
      " is stale (worker has seen " + std::to_string(g_epoch_max) + ")";
  if (name == "serve_open" || name == "serve_close") {
    emit_serve_error(id, "stale_epoch", message, true);
  } else if (name == "serve_request") {
    emit("{\"event\":\"telemetry\",\"id\":\"" + json_escape(id) +
         "\",\"data\":{\"type\":\"serve.reject\",\"rid\":\"" +
         json_escape(rid) + "\",\"code\":\"stale_epoch\",\"message\":\"" +
         json_escape(message) + "\"}}");
  } else if (name == "serve_prefill") {
    emit("{\"event\":\"serve_kv\",\"id\":\"" + json_escape(id) +
         "\",\"rid\":\"" + json_escape(rid) +
         "\",\"code\":\"stale_epoch\",\"message\":\"" +
         json_escape(message) + "\"}");
  } else if (name == "serve_resume") {
    emit("{\"event\":\"serve_resumed\",\"id\":\"" + json_escape(id) +
         "\",\"rid\":\"" + json_escape(rid) +
         "\",\"state\":\"refused\",\"code\":\"stale_epoch\"}");
  } else if (name == "serve_attach" || name == "serve_detach") {
    const Json* a = cmd.get("adapter");
    emit("{\"event\":\"" + name + "ed\",\"id\":\"" + json_escape(id) +
         "\",\"adapter\":\"" +
         json_escape(a && a->type == Json::Str ? a->s : "") +
         "\",\"code\":\"stale_epoch\",\"message\":\"" +
         json_escape(message) + "\",\"permanent\":true}");
  } else if (name == "register_fn") {
    const Json* d = cmd.get("digest");
    emit("{\"event\":\"register_error\",\"digest\":\"" +
         json_escape(d && d->type == Json::Str ? d->s : "") +
         "\",\"code\":\"stale_epoch\",\"message\":\"" +
         json_escape(message) + "\"}");
  } else {
    emit("{\"event\":\"error\",\"id\":\"" + json_escape(id) +
         "\",\"code\":\"stale_epoch\",\"message\":\"" +
         json_escape(message) + "\"}");
  }
  return true;
}

// What survives in THIS worker: session runner children (sid + pid; the
// stream detail lives in the runner — the recovering dispatcher resumes
// through serve_resume, which is forwarded), and forked task children.
static void serve_inventory_cmd() {
  std::string out =
      "{\"event\":\"serve_inventory\",\"pid\":" + std::to_string(getpid()) +
      ",\"epoch\":" + std::to_string(g_epoch_max) + ",\"sessions\":[";
  bool first = true;
  for (const auto& kv : g_serve_children) {
    if (!first) out += ",";
    first = false;
    out += "{\"sid\":\"" + json_escape(kv.first) +
           "\",\"pid\":" + std::to_string(kv.second.pid) + "}";
  }
  out += "]}";
  emit(out);
}

static void task_inventory_cmd() {
  std::string out =
      "{\"event\":\"task_inventory\",\"pid\":" + std::to_string(getpid()) +
      ",\"epoch\":" + std::to_string(g_epoch_max) + ",\"tasks\":[";
  bool first = true;
  for (const auto& kv : g_tasks) {
    bool is_serve = false;
    for (const auto& sc : g_serve_children)
      if (sc.second.pid == kv.first) { is_serve = true; break; }
    if (is_serve) continue;
    if (!first) out += ",";
    first = false;
    out += "{\"id\":\"" + json_escape(kv.second.id) +
           "\",\"pid\":" + std::to_string(kv.first) + "}";
  }
  out += "]}";
  emit(out);
}

// ---------------------------------------------------------------------------
// Main loop: poll stdin + the SIGCHLD self-pipe.
// ---------------------------------------------------------------------------

static void handle_line(const std::string& line, bool& running) {
  if (line.empty()) return;
  Json cmd;
  if (!parse_json(line, cmd) || cmd.type != Json::Obj) {
    emit_error("malformed command line");
    return;
  }
  const Json* cmd_field = cmd.get("cmd");
  if (!cmd_field || cmd_field->type != Json::Str) {
    emit_error("missing cmd field");
    return;
  }
  const std::string& name = cmd_field->s;
  if (name == "ping") emit("{\"event\":\"pong\"}");
  else if (name == "frames") {
    // Negotiation: ack then flip to frames.  The kill switch answers
    // version 0 so a capable client settles on JSONL immediately.
    if (frames_env_enabled()) {
      emit("{\"event\":\"frames\",\"version\":1}");
      g_frames = true;
    } else {
      emit("{\"event\":\"frames\",\"version\":0}");
    }
  }
  else if (name == "epoch") handle_epoch(cmd);
  else if (name == "serve_inventory") serve_inventory_cmd();
  else if (name == "task_inventory") task_inventory_cmd();
  else if (fence_refuse(name, cmd)) return;
  else if (name == "run") spawn(cmd);
  else if (name == "register_fn") register_fn(cmd);
  else if (name == "invoke") invoke_task(cmd, line + "\n");
  else if (name == "serve_open") serve_open(cmd, line);
  else if (name == "serve_request") serve_forward(cmd, line + "\n", false);
  else if (name == "serve_resume") serve_forward(cmd, line + "\n", false);
  else if (name == "serve_cancel") serve_forward(cmd, line + "\n", false);
  else if (name == "serve_prefill") serve_prefill_forward(cmd, line + "\n");
  else if (name == "serve_attach" || name == "serve_detach")
    serve_attach_forward(cmd, name, line + "\n");
  else if (name == "serve_close") serve_forward(cmd, line + "\n", true);
  else if (name == "profile_start") profile_forward(cmd, line, false);
  else if (name == "profile_stop") profile_forward(cmd, line, true);
  else if (name == "kill") kill_task(cmd);
  else if (name == "watch") watch_task(cmd);
  else if (name == "unwatch") unwatch_task(cmd);
  else if (name == "shutdown") { emit("{\"event\":\"bye\"}"); running = false; }
  else emit_error("unknown cmd: " + name);
}

// One complete inbound FRAME: route by the header's cmd.  Frames whose
// body must reach a runner child (invoke, serve_request/close) forward
// the raw frame bytes verbatim; header-only commands replay through
// handle_line — the header IS the JSON command.  A non-JSON header is a
// consumed, sync-preserving refusal (the lengths were valid).
static void handle_frame(const std::string& header, const std::string& raw,
                         bool& running) {
  Json cmd;
  if (!parse_json(header, cmd) || cmd.type != Json::Obj) {
    emit_error("bad frame header");
    return;
  }
  const Json* cmd_field = cmd.get("cmd");
  const std::string name =
      (cmd_field && cmd_field->type == Json::Str) ? cmd_field->s : "";
  if (fence_refuse(name, cmd)) return;
  if (name == "invoke") {
    invoke_task(cmd, raw);
  } else if (name == "multi_invoke") {
    // Batched invoke needs the resident pool interpreter; this agent
    // forks one runner per invocation.  Clients only batch toward pool
    // runtimes — refuse per op so no waiter sits out its timeout.
    const Json* ops = cmd.get("ops");
    if (ops && ops->type == Json::Arr) {
      for (const auto& op : ops->arr) {
        const Json* id = op.get("id");
        emit("{\"event\":\"error\",\"id\":\"" +
             json_escape(id && id->type == Json::Str ? id->s : "") +
             "\",\"code\":\"unsupported\",\"message\":\"multi_invoke "
             "requires the pool runtime\"}");
      }
    } else {
      emit_error("multi_invoke requires ops");
    }
  } else if (name == "serve_request") {
    serve_forward(cmd, raw, false);
  } else if (name == "serve_prefill") {
    serve_prefill_forward(cmd, raw);
  } else if (name == "serve_attach" || name == "serve_detach") {
    serve_attach_forward(cmd, name, raw);
  } else if (name == "serve_close") {
    serve_forward(cmd, raw, true);
  } else {
    handle_line(header, running);
  }
}

// Extract every complete message (frame or line) from the stdin buffer.
// Malformed frames answer a clean error and resync at the next newline —
// the command loop must keep serving (fuzz contract: fail loud, never
// hang); a frame truncated by channel death simply stays buffered until
// the read loop sees EOF.
static void process_buffer(std::string& buffer, bool& running) {
  while (!buffer.empty()) {
    if ((unsigned char)buffer[0] == kFrameMagic0) {
      if (buffer.size() < kFrameHeaderLen) return;
      if ((unsigned char)buffer[1] != kFrameMagic1 ||
          (unsigned char)buffer[2] != kFrameVersion) {
        emit("{\"event\":\"error\",\"code\":\"bad_frame\",\"message\":"
             "\"bad frame magic/version\"}");
        frame_resync(buffer);
        continue;
      }
      uint64_t hl = read_be32(buffer.data() + 5);
      uint64_t bl = read_be32(buffer.data() + 9);
      if (hl > kFrameMaxHeader || bl > kFrameMaxBody) {
        emit("{\"event\":\"error\",\"code\":\"bad_frame\",\"message\":"
             "\"oversized frame\"}");
        frame_resync(buffer);
        continue;
      }
      uint64_t total = kFrameHeaderLen + hl + bl;
      if (buffer.size() < total) return;
      std::string header = buffer.substr(kFrameHeaderLen, (size_t)hl);
      std::string raw = buffer.substr(0, (size_t)total);
      buffer.erase(0, (size_t)total);
      handle_frame(header, raw, running);
    } else {
      size_t pos = buffer.find('\n');
      if (pos == std::string::npos) return;
      std::string line = buffer.substr(0, pos);
      buffer.erase(0, pos + 1);
      handle_line(line, running);
    }
  }
}

int main() {
  if (pipe(g_sigchld_pipe) != 0) return 1;
  fcntl(g_sigchld_pipe[0], F_SETFL, O_NONBLOCK);
  fcntl(g_sigchld_pipe[1], F_SETFL, O_NONBLOCK);

  struct sigaction sa;
  memset(&sa, 0, sizeof sa);
  sa.sa_handler = on_sigchld;
  sa.sa_flags = SA_RESTART | SA_NOCLDSTOP;
  sigaction(SIGCHLD, &sa, nullptr);
  signal(SIGPIPE, SIG_IGN);

  std::string banner =
      "{\"event\":\"ready\",\"pid\":" + std::to_string((long long)getpid());
  if (frames_env_enabled()) banner += ",\"frames\":1";
  emit(banner + "}");

  std::string buffer;
  bool running = true;
  bool stdin_open = true;
  char chunk[4096];

  // Keep serving until shutdown — or, after stdin closes, until every child
  // is reaped AND every RPC runner's stream is drained, so neither an exit
  // event nor a buffered result line is lost on a clean drain.
  while (running && (stdin_open || !g_tasks.empty() || !g_rpc_streams.empty())) {
    std::vector<struct pollfd> fds;
    if (stdin_open) fds.push_back({0, POLLIN, 0});
    fds.push_back({g_sigchld_pipe[0], POLLIN, 0});
    for (const auto& kv : g_rpc_streams) fds.push_back({kv.first, POLLIN, 0});

    // Live watchers wake the loop on a short tick so telemetry flows
    // without inbound traffic; otherwise block until a command/SIGCHLD/
    // runner output.
    int rc = poll(fds.data(), (nfds_t)fds.size(), g_watchers.empty() ? -1 : 250);
    if (rc < 0) {
      if (errno == EINTR) { reap_children(); pump_watchers(); continue; }
      break;
    }
    pump_watchers();

    for (size_t k = 0; k < fds.size(); k++) {
      if (!(fds[k].revents & (POLLIN | POLLHUP | POLLERR))) continue;
      if (fds[k].fd == g_sigchld_pipe[0]) {
        char drain[64];
        while (read(g_sigchld_pipe[0], drain, sizeof drain) > 0) {}
        reap_children();
      } else if (fds[k].fd != 0) {
        // Runner stream (a stream erased earlier this sweep is a no-op
        // inside pump_rpc_stream — never fall through to the stdin read).
        pump_rpc_stream(fds[k].fd);
      } else {
        ssize_t n = read(0, chunk, sizeof chunk);
        if (n <= 0) {
          // Channel dropped: children keep running in their own sessions;
          // the executor resumes supervision via the pid-file polling path.
          // Serving children, by contrast, die with the channel (no client
          // can reach them anymore): EOF their stdin so they drain and
          // exit instead of holding model memory forever.
          stdin_open = false;
          for (auto& kv : g_serve_children) close(kv.second.stdin_fd);
          g_serve_children.clear();
          continue;
        }
        buffer.append(chunk, (size_t)n);
        process_buffer(buffer, running);
      }
    }
  }
  return 0;
}
